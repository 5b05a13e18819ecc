"""glog-style logging/check helpers (reference: tachyon/base/logging.h —
LOG/VLOG/CHECK/CHECK_EQ over glog).

The port's own copy of ``tachyon_tpu/base/log.py``, so that the port imports
nothing of the JAX package; only its imports and its logger's name
(``tachyon_tpu_torch``) differ.

Python's stdlib logger carries the stream; this module adds the two glog
idioms the reference leans on: numbered verbosity (VLOG(1/2) progress and
challenge logging, e.g. zk/plonk/halo2/prover.h:127-134) and CHECK-family
fatal assertions that always fire (unlike `assert` under -O).

Verbosity comes from TACHYON_VLOG (int, default 0) or set_vlog_level().
"""
from __future__ import annotations

import logging
import os

logger = logging.getLogger("tachyon_tpu_torch")

_vlog_level = 0
_handler: logging.Handler | None = None


def _configure(level: int) -> None:
    """Mirror glog: VLOG goes to stderr whenever verbosity > 0.  Without
    this the 'tachyon_tpu_torch' logger has no handler and Python's last-resort
    WARNING handler silently drops INFO records."""
    global _handler
    if level > 0:
        if _handler is None:
            _handler = logging.StreamHandler()  # stderr
            _handler.setFormatter(
                logging.Formatter("I %(asctime)s %(name)s] %(message)s")
            )
            logger.addHandler(_handler)
        if logger.level == logging.NOTSET or logger.level > logging.INFO:
            logger.setLevel(logging.INFO)
    elif _handler is not None:
        logger.removeHandler(_handler)
        _handler = None


def set_vlog_level(level: int) -> None:
    global _vlog_level
    _vlog_level = int(level)
    _configure(_vlog_level)


set_vlog_level(int(os.environ.get("TACHYON_VLOG", "0")))


def vlog_is_on(level: int) -> bool:
    return _vlog_level >= level


def vlog(level: int, msg: str, *args) -> None:
    """VLOG(level) — INFO-stream message gated on the verbosity knob."""
    if _vlog_level >= level:
        logger.info(msg, *args)


class CheckError(AssertionError):
    pass


def check(cond, msg: str = "CHECK failed") -> None:
    if not cond:
        raise CheckError(msg)


def check_eq(a, b, msg: str = "") -> None:
    if a != b:
        raise CheckError(f"CHECK_EQ failed: {a!r} != {b!r} {msg}".rstrip())


def check_ne(a, b, msg: str = "") -> None:
    if a == b:
        raise CheckError(f"CHECK_NE failed: {a!r} == {b!r} {msg}".rstrip())


def check_le(a, b, msg: str = "") -> None:
    if not (a <= b):
        raise CheckError(f"CHECK_LE failed: {a!r} > {b!r} {msg}".rstrip())


def check_lt(a, b, msg: str = "") -> None:
    if not (a < b):
        raise CheckError(f"CHECK_LT failed: {a!r} >= {b!r} {msg}".rstrip())

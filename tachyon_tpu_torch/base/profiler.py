"""Tracing and profiling hooks (analog of the reference's Perfetto profiler).

Port of ``tachyon_tpu/base/profiler.py``.  The reference wires Perfetto
track events through every hot path with a fixed category taxonomy
(reference: tachyon/base/profiler.h:12-52; TRACE_EVENT macros e.g.
pippenger.h:82, zk/plonk/halo2/prover.h:71); the categories and the
``Profiler``, ``trace_event`` and ``collect_events`` API are the JAX
package's.  Where the JAX package starts a ``jax.profiler`` trace,
``Profiler`` runs ``torch.profiler`` (CPU activity, and the card's kernels
with CUDA activity) and writes a chrome trace (JSON, loadable in Perfetto
or chrome://tracing); ``trace_event(category, name)`` is a host span plus a
``torch.profiler.record_function`` range named ``category/name``, which
holds the kernels launched inside it in the trace.

Tracing costs nothing when no Profiler (or ``collect_events``) is active:
``trace_event`` returns on a module flag before it touches the profiler.
"""
from __future__ import annotations

import contextlib
import time

import torch

# category taxonomy mirrored from the reference (profiler.h:12-23)
CATEGORY_UTILS = "Utils"
CATEGORY_SUBTASK = "Subtask"
CATEGORY_MSM = "MSM"
CATEGORY_NTT = "EvaluationDomain"
CATEGORY_PROOF_GENERATION = "ProofGeneration"
CATEGORY_PROOF_VERIFICATION = "ProofVerification"

_active = False
_events: list[tuple[str, str, float, float]] = []


class Profiler:
    """Runs ``torch.profiler`` between ``start`` and ``stop`` and writes a
    chrome trace to ``trace_path`` (reference: base/profiler.h Profiler;
    CLI flag --trace_path in vendors/circom/prover_main.cc:211).  The
    trace holds the card's kernels unless ``device`` is the CPU; on a host
    without CUDA the default device raises."""

    def __init__(self, trace_path: str, device=torch.device("cuda")):
        self.trace_path = trace_path
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Profiler: no CUDA device; pass device='cpu' to trace "
                               "the host only")
        self._prof = None

    def start(self):
        global _active
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        _active = True

    def stop(self):
        global _active
        _active = False
        if self._prof is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._prof.stop()
            self._prof.export_chrome_trace(self.trace_path)
            self._prof = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


@contextlib.contextmanager
def trace_event(category: str, name: str):
    """Host span + profiler range, recorded only while a Profiler (or
    collect_events) is active."""
    if not _active:
        yield
        return
    t0 = time.perf_counter()
    with torch.profiler.record_function(f"{category}/{name}"):
        yield
    _events.append((category, name, t0, time.perf_counter()))


@contextlib.contextmanager
def collect_events():
    """Host-side event collection without a profiler trace (tests and
    timing summaries).  Yields the list that accumulates (category, name,
    t_start, t_end) tuples."""
    global _active
    prev = _active
    _active = True
    _events.clear()
    try:
        yield _events
    finally:
        _active = prev

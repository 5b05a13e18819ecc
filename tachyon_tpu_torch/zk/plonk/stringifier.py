"""Pinned verifying-key stringifier — halo2 Rust-Debug-compatible.

The port's own copy of ``tachyon_tpu/zk/plonk/stringifier.py``, so that the
port imports nothing of the JAX package; only its imports differ.

Analog of the reference's stringifier stack
(reference: tachyon/zk/plonk/halo2/pinned_verifying_key.h,
pinned_constraint_system.h, pinned_evaluation_domain.h, pinned_gates.h,
stringifiers/*.h, base/strings/rust_stringifier.h;
zk/plonk/keys/verifying_key.h:102-124 SetTranscriptRepresentative).

Reproduces Rust's non-alternate `{:?}` formatting of halo2's
PinnedVerificationKey exactly (struct = "Name { f: v, g: w }" with
space-padded braces, tuple = "Name(a, b)", list = "[a, b]",
Option = None/Some(x)), so the blake2b transcript representative matches
upstream halo2 bit-for-bit for an identical circuit.  Golden-tested against
the reference's zk/plonk/examples/simple_circuit_test_data.h pinned
strings.
"""
from __future__ import annotations

import hashlib

from tachyon_tpu_torch.zk.plonk import expressions as ex
from tachyon_tpu_torch.zk.plonk.constraint_system import ColumnRef, ConstraintSystem

VERIFY_KEY_PERSON = b"Halo2-Verify-Key"

_KIND_NAME = {"fixed": "Fixed", "advice": "Advice", "instance": "Instance"}


def _hex(v: int, nbytes: int = 32) -> str:
    """full-width padded hex (reference: field ToHexString(true))."""
    return "0x" + format(int(v), f"0{2 * nbytes}x")


def _struct(name: str, fields: list[tuple[str, str]]) -> str:
    inner = ", ".join(f"{k}: {v}" for k, v in fields)
    return f"{name} {{ {inner} }}"


def _tuple(name: str, fields: list[str]) -> str:
    return f"{name}({', '.join(fields)})"


def _list(entries: list[str]) -> str:
    return "[" + ", ".join(entries) + "]"


def _rotation(r: int) -> str:
    return _tuple("Rotation", [str(int(r))])


def _column(kind: str, index: int, cs=None) -> str:
    type_str = _KIND_NAME[kind]
    if kind == "advice" and cs is not None:
        phases = getattr(cs, "advice_column_phases", [])
        if index < len(phases) and phases[index] != 0:
            # (reference: column_key_stringifier.h — phased advice prints
            # Advice { phase: Phase(p) })
            type_str = _struct(
                "Advice", [("phase", _tuple("Phase", [str(phases[index])]))])
    return _struct(
        "Column",
        [("index", str(int(index))), ("column_type", type_str)],
    )


def _query(kind: str, index: int, rotation: int, cs=None) -> str:
    # halo2 queries Debug as the anonymous tuple (Column, Rotation)
    return _tuple("", [_column(kind, index, cs), _rotation(rotation)])


def expression_str(e, cs: ConstraintSystem) -> str:
    """Rust Debug of a halo2 Expression
    (reference: stringifiers/expression_stringifier.h)."""
    if isinstance(e, ex.Constant):
        return _tuple("Constant", [_hex(e.value)])
    if isinstance(e, ex.Fixed):
        qi = cs.query_index(ColumnRef("fixed", e.column), e.rotation)
        return _struct("Fixed", [
            ("query_index", str(qi)),
            ("column_index", str(e.column)),
            ("rotation", _rotation(e.rotation)),
        ])
    if isinstance(e, ex.Advice):
        qi = cs.query_index(ColumnRef("advice", e.column), e.rotation)
        fields = [
            ("query_index", str(qi)),
            ("column_index", str(e.column)),
            ("rotation", _rotation(e.rotation)),
        ]
        # non-first-phase columns also pin their phase
        # (reference: expression_stringifier.h:57-59)
        phases = getattr(cs, "advice_column_phases", [])
        if e.column < len(phases) and phases[e.column] != 0:
            fields.append(("phase", _tuple("Phase", [str(phases[e.column])])))
        return _struct("Advice", fields)
    if isinstance(e, ex.Instance):
        qi = cs.query_index(ColumnRef("instance", e.column), e.rotation)
        return _struct("Instance", [
            ("query_index", str(qi)),
            ("column_index", str(e.column)),
            ("rotation", _rotation(e.rotation)),
        ])
    if isinstance(e, ex.Challenge):
        # Challenge(Challenge { index: i, phase: Phase(p) })
        # (reference: stringifiers/{expression,challenge,phase}_stringifier.h)
        inner = _struct("Challenge", [
            ("index", str(e.index)),
            ("phase", _tuple("Phase", [str(e.phase)])),
        ])
        return _tuple("Challenge", [inner])
    if isinstance(e, ex.Selector):
        # pre-compression pinned string (reference:
        # stringifiers/selector_stringifier.h: Selector(Selector(i, kind)))
        kind = "true" if e.is_simple else "false"
        return _tuple("Selector", [_tuple("Selector", [str(e.index), kind])])
    if isinstance(e, ex.Negated):
        return _tuple("Negated", [expression_str(e.expr, cs)])
    if isinstance(e, ex.Sum):
        return _tuple(
            "Sum", [expression_str(e.left, cs), expression_str(e.right, cs)]
        )
    if isinstance(e, ex.Product):
        return _tuple(
            "Product",
            [expression_str(e.left, cs), expression_str(e.right, cs)],
        )
    if isinstance(e, ex.Scaled):
        return _tuple("Scaled", [expression_str(e.expr, cs), _hex(e.scale)])
    raise TypeError(e)


def pinned_constraint_system_str(cs: ConstraintSystem) -> str:
    """reference: pinned_constraint_system.h RustDebugStringifier."""
    cs.collect_queries()
    fields: list[tuple[str, str]] = [
        ("num_fixed_columns", str(cs.num_fixed)),
        ("num_advice_columns", str(cs.num_advice)),
        ("num_instance_columns", str(cs.num_instance)),
        ("num_selectors", str(cs.num_selectors)),
    ]
    if cs.num_challenges > 0:
        # (reference: pinned_constraint_system.h:129-135)
        fields.append(("num_challenges", str(cs.num_challenges)))
        fields.append(("advice_column_phase", _list(
            [_tuple("Phase", [str(p)]) for p in cs.advice_column_phases])))
        fields.append(("challenge_phase", _list(
            [_tuple("Phase", [str(p)]) for p in cs.challenge_phases])))
    gates = _list([
        expression_str(p, cs) for g in cs.gates for p in g.polys
    ])
    fields.append(("gates", gates))
    fields.append(("advice_queries", _list([
        _query("advice", c, r, cs) for c, r in cs.advice_queries
    ])))
    fields.append(("instance_queries", _list([
        _query("instance", c, r) for c, r in cs.instance_queries
    ])))
    fields.append(("fixed_queries", _list([
        _query("fixed", c, r) for c, r in cs.fixed_queries
    ])))
    fields.append(("permutation", _struct("Argument", [(
        "columns",
        _list([_column(c.kind, c.index, cs) for c in cs.permutation_columns]),
    )])))
    if cs.lookup_type == "halo2":
        fields.append(("lookups", _list([
            _struct("Argument", [
                ("input_expressions", _list(
                    [expression_str(e, cs) for e in lk.input_exprs])),
                ("table_expressions", _list(
                    [expression_str(e, cs) for e in lk.table_exprs])),
            ])
            for lk in cs.lookups
        ])))
    else:
        # log-derivative (Scroll) lookups pin as identifier->tracker map in
        # btree key order (reference: lookup_tracker_stringifier.h +
        # rust_stringifier.h DebugMap; trackers survive chunking)
        entries = ", ".join(
            f'"{key}": ' + _struct("LookupTracker", [
                ("table", _list(
                    [expression_str(e, cs)
                     for e in cs.lookups_map[key].table_exprs])),
                ("inputs", _list([
                    _list([expression_str(e, cs) for e in inputs])
                    for inputs in cs.lookups_map[key].inputs
                ])),
            ])
            for key in sorted(cs.lookups_map)
        )
        fields.append(("lookups_map", "{" + entries + "}"))
    fields.append(("constants", _list([
        _column(c.kind, c.index, cs) for c in cs.constants
    ])))
    md = cs.minimum_degree
    fields.append(
        ("minimum_degree", "None" if md is None else f"Some({md})")
    )
    return _struct("PinnedConstraintSystem", fields)


def pinned_vk_str(
    cs: ConstraintSystem,
    k: int,
    extended_k: int,
    omega: int,
    fixed_commitments: list,
    permutation_commitments: list,
    base_modulus: int,
    scalar_modulus: int,
) -> str:
    """reference: pinned_verifying_key.h (original halo2 name is
    PinnedVerificationKey)."""

    def point(cm) -> str:
        if cm is None:
            return "Infinity"
        x, y = cm
        return _tuple("", [_hex(x), _hex(y)])

    return _struct("PinnedVerificationKey", [
        ("base_modulus", f'"{_hex(base_modulus)}"'),
        ("scalar_modulus", f'"{_hex(scalar_modulus)}"'),
        ("domain", _struct("PinnedEvaluationDomain", [
            ("k", str(k)),
            ("extended_k", str(extended_k)),
            ("omega", _hex(omega)),
        ])),
        ("cs", pinned_constraint_system_str(cs)),
        ("fixed_commitments", _list(
            [point(cm) for cm in fixed_commitments])),
        ("permutation", _struct("VerifyingKey", [(
            "commitments",
            _list([point(cm) for cm in permutation_commitments]),
        )])),
    ])


def transcript_repr_from_str(vk_str: str, scalar_modulus: int) -> int:
    """blake2b-512(person="Halo2-Verify-Key", u64-LE length || string),
    taken as LE u512 mod r (reference: verifying_key.h:115-124 +
    halo2/prime_field_conversion.h FromUint512)."""
    h = hashlib.blake2b(digest_size=64, person=VERIFY_KEY_PERSON)
    data = vk_str.encode()
    h.update(len(data).to_bytes(8, "little"))
    h.update(data)
    return int.from_bytes(h.digest(), "little") % scalar_modulus

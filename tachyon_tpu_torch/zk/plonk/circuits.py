"""Python mirrors of the reference's halo2 example circuits
(reference: tachyon/zk/plonk/examples/simple_circuit.h — itself halo2's
simple-example.rs).

The port's copy of the JAX package's ``tests/circuits_halo2.py``, over the
port's expressions and floor planners, so that ``chip_smoke.py`` builds
them without the JAX package: ``SimpleCircuit``, ``SimpleLookupCircuit``,
``Fibonacci1/2/3Circuit``, ``MultiLookupCircuit``, ``ShuffleAPICircuit``
and ``ShuffleCircuit``, driven through ``zk/plonk/halo2.py``.
"""
from __future__ import annotations

import dataclasses

from tachyon_tpu_torch.zk.plonk import expressions as ex
from tachyon_tpu_torch.zk.plonk.layout import SimpleFloorPlanner, V1FloorPlanner
from tachyon_tpu_torch.zk.plonk.halo2 import FR


@dataclasses.dataclass
class FieldConfig:
    advice: list
    instance: object
    constant: object
    s_mul: ex.Selector


class SimpleCircuit:
    """c = constant * a^2 * b^2 via three mul gates
    (reference: simple_circuit.h:57-230)."""

    def __init__(self, constant=7, a=2, b=3, planner=SimpleFloorPlanner):
        self.constant = constant
        self.a = a
        self.b = b
        self._planner_cls = planner

    def floor_planner(self, cs, n):
        return self._planner_cls(cs, n)

    @staticmethod
    def configure(cs) -> FieldConfig:
        advice = [cs.advice_column(), cs.advice_column()]
        instance = cs.instance_column()
        constant = cs.fixed_column()
        # FieldChip::Configure (simple_circuit.h:63-113)
        cs.enable_equality(instance)
        cs.enable_constant(constant)
        for col in advice:
            cs.enable_equality(col)
        sel = cs.create_simple_selector()
        lhs = cs.query(advice[0], 0)
        rhs = cs.query(advice[1], 0)
        out = cs.query(advice[0], 1)
        s_mul = cs.query_selector(sel)
        cs.create_gate("mul", [
            ex.Product(s_mul, ex.Sum(ex.Product(lhs, rhs), ex.Negated(out)))
        ])
        return FieldConfig(advice=advice, instance=instance,
                           constant=constant, s_mul=sel)

    # chip ops --------------------------------------------------------------
    def _load_private(self, layouter, config, value):
        def fn(region):
            return region.assign_advice(config.advice[0], 0, value)
        cell = layouter.assign_region("load private", fn)
        return cell, value

    def _load_constant(self, layouter, config, value):
        def fn(region):
            return region.assign_advice_from_constant(
                value, config.advice[0], 0)
        cell = layouter.assign_region("load constant", fn)
        return cell, value

    def _mul(self, layouter, config, a, b):
        (a_cell, a_val), (b_cell, b_val) = a, b
        out_val = a_val * b_val % FR

        def fn(region):
            region.enable_selector(config.s_mul, 0)
            lhs = region.assign_advice(config.advice[0], 0, a_val)
            region.constrain_equal(lhs, a_cell)
            rhs = region.assign_advice(config.advice[1], 0, b_val)
            region.constrain_equal(rhs, b_cell)
            return region.assign_advice(config.advice[0], 1, out_val)

        cell = layouter.assign_region("mul", fn)
        return cell, out_val

    def synthesize(self, config, layouter):
        a = self._load_private(layouter, config, self.a)
        b = self._load_private(layouter, config, self.b)
        const = self._load_constant(layouter, config, self.constant)
        ab = self._mul(layouter, config, a, b)
        absq = self._mul(layouter, config, ab, ab)
        c = self._mul(layouter, config, const, absq)
        layouter.constrain_instance(c[0], config.instance, 0)

    def instance_columns(self):
        c = self.constant * self.a ** 2 * self.b ** 2 % FR
        return [[c]]


class SimpleLookupCircuit:
    """2^k advice rows each constrained into a 3-bit lookup table
    (reference: simple_lookup_circuit.h; kBits=3 per
    simple_lookup_circuit_test.cc:14, circuit k=4, domain n=32)."""

    BITS = 3

    def __init__(self, k=4, planner=SimpleFloorPlanner):
        self.k = k
        self._planner_cls = planner

    def floor_planner(self, cs, n):
        return self._planner_cls(cs, n)

    @staticmethod
    def configure(cs):
        sel = cs.create_complex_selector()
        table = cs.fixed_column()  # CreateLookupTableColumn
        advice = cs.advice_column()
        selector = cs.query_selector(sel)
        not_selector = ex.Sum(ex.Constant(1), ex.Negated(selector))
        adv = cs.query(advice, 0)
        table_expr = cs.query(table, 0)
        cs.lookup("lookup", [(
            ex.Sum(ex.Product(selector, adv), not_selector), table_expr)])
        return {"selector": sel, "table": table, "advice": advice}

    def synthesize(self, config, layouter):
        def load_table(table):
            for row in range(1 << self.BITS):
                table.assign_cell(config["table"], row, row + 1)
        layouter.assign_lookup_table(f"{self.BITS}-bit table", load_table)

        modulus = 1 << self.BITS

        def fn(region):
            for offset in range(1 << self.k):
                region.enable_selector(config["selector"], offset)
                region.assign_advice(config["advice"], offset,
                                     offset % modulus + 1)
        layouter.assign_region("assign values", fn)

    def instance_columns(self):
        return []


class Fibonacci1Circuit:
    """f(0)=f(1)=1, 8 add rows, out = f(9) exposed at instance row 2
    (reference: fibonacci/fibonacci1_circuit.h)."""

    def __init__(self, planner=SimpleFloorPlanner):
        self._planner_cls = planner

    def floor_planner(self, cs, n):
        return self._planner_cls(cs, n)

    @staticmethod
    def configure(cs):
        advice = [cs.advice_column() for _ in range(3)]
        sel = cs.create_simple_selector()
        instance = cs.instance_column()
        for col in advice:
            cs.enable_equality(col)
        cs.enable_equality(instance)
        s = cs.query_selector(sel)
        a = cs.query(advice[0], 0)
        b = cs.query(advice[1], 0)
        c = cs.query(advice[2], 0)
        cs.create_gate("add", [
            ex.Product(s, ex.Sum(ex.Sum(a, b), ex.Negated(c)))
        ])
        return {"advice": advice, "selector": sel, "instance": instance}

    def synthesize(self, config, layouter):
        adv, sel, inst = config["advice"], config["selector"], config["instance"]

        state = {}

        def first_row(region):
            region.enable_selector(sel, 0)
            a_cell = region.assign_advice_from_instance(inst, 0, adv[0], 0)
            b_cell = region.assign_advice_from_instance(inst, 1, adv[1], 0)
            a_val = layouter.assignment.get(inst, 0)
            b_val = layouter.assignment.get(inst, 1)
            c_val = (a_val + b_val) % FR
            c_cell = region.assign_advice(adv[2], 0, c_val)
            state["prev"] = ((b_cell, b_val), (c_cell, c_val))

        layouter.assign_region("first row", first_row)

        for _i in range(3, 10):
            (b_cell, b_val), (c_cell, c_val) = state["prev"]

            def next_row(region, b_cell=b_cell, b_val=b_val,
                         c_cell=c_cell, c_val=c_val):
                region.enable_selector(sel, 0)
                a_new = region.assign_advice(adv[0], 0, b_val)
                region.constrain_equal(a_new, b_cell)
                b_new = region.assign_advice(adv[1], 0, c_val)
                region.constrain_equal(b_new, c_cell)
                out_val = (b_val + c_val) % FR
                out_cell = region.assign_advice(adv[2], 0, out_val)
                state["out"] = (out_cell, out_val)

            layouter.assign_region("next row", next_row)
            state["prev"] = (state["prev"][1], state["out"])

        layouter.constrain_instance(state["prev"][1][0], inst, 2)

    def instance_columns(self):
        f = [1, 1]
        for _ in range(8):
            f.append(f[-2] + f[-1])
        return [[1, 1, f[9]]]


class Fibonacci2Circuit:
    """single-column fibonacci with Rotation(1)/Rotation(2) gate
    (reference: fibonacci/fibonacci2_circuit.h)."""

    def __init__(self, planner=SimpleFloorPlanner):
        self._planner_cls = planner

    def floor_planner(self, cs, n):
        return self._planner_cls(cs, n)

    @staticmethod
    def configure(cs):
        advice = cs.advice_column()
        instance = cs.instance_column()
        sel = cs.create_simple_selector()
        cs.enable_equality(advice)
        cs.enable_equality(instance)
        s = cs.query_selector(sel)
        a = cs.query(advice, 0)
        b = cs.query(advice, 1)
        c = cs.query(advice, 2)
        cs.create_gate("add", [
            ex.Product(s, ex.Sum(ex.Sum(a, b), ex.Negated(c)))
        ])
        return {"advice": advice, "selector": sel, "instance": instance}

    def synthesize(self, config, layouter):
        adv, sel, inst = config["advice"], config["selector"], config["instance"]
        n_rows = 10
        out = {}

        def entire(region):
            region.enable_selector(sel, 0)
            region.enable_selector(sel, 1)
            a_cell = region.assign_advice_from_instance(inst, 0, adv, 0)
            b_cell = region.assign_advice_from_instance(inst, 1, adv, 1)
            a_val = layouter.assignment.get(inst, 0)
            b_val = layouter.assignment.get(inst, 1)
            for row in range(2, n_rows):
                if row < n_rows - 2:
                    region.enable_selector(sel, row)
                c_val = (a_val + b_val) % FR
                c_cell = region.assign_advice(adv, row, c_val)
                a_cell, a_val = b_cell, b_val
                b_cell, b_val = c_cell, c_val
            out["cell"] = b_cell

        layouter.assign_region("entire fibonacci table", entire)
        layouter.constrain_instance(out["cell"], inst, 2)

    def instance_columns(self):
        f = [1, 1]
        for _ in range(8):
            f.append(f[-2] + f[-1])
        return [[1, 1, f[9]]]


class Fibonacci3Circuit:
    """if a == b {c} else {a - b} with an is_zero chip
    (reference: fibonacci/fibonacci3_circuit.h + is_zero_chip.h)."""

    def __init__(self, a=10, b=12, c=15, planner=SimpleFloorPlanner):
        self.a, self.b, self.c = a, b, c
        self._planner_cls = planner

    def floor_planner(self, cs, n):
        return self._planner_cls(cs, n)

    @staticmethod
    def configure(cs):
        sel = cs.create_simple_selector()
        a = cs.advice_column()
        b = cs.advice_column()
        c = cs.advice_column()
        output = cs.advice_column()
        value_inv = cs.advice_column()
        # IsZeroChip::Configure (is_zero_chip.h:39-78)
        s = cs.query_selector(sel)
        a_q = cs.query(a, 0)
        b_q = cs.query(b, 0)
        value = ex.Sum(a_q, ex.Negated(b_q))
        inv_q = cs.query(value_inv, 0)
        is_zero = ex.Sum(ex.Constant(1),
                         ex.Negated(ex.Product(value, inv_q)))
        cs.create_gate("is_zero", [ex.Product(ex.Product(s, value), is_zero)])
        # main gate (fibonacci3_circuit.h:74-98)
        s2 = cs.query_selector(sel)
        a2 = cs.query(a, 0)
        b2 = cs.query(b, 0)
        c2 = cs.query(c, 0)
        out2 = cs.query(output, 0)
        cs.create_gate("f(a, b, c) = if a == b {c} else {a - b}", [
            ex.Product(s2, ex.Product(is_zero, ex.Sum(out2, ex.Negated(c2)))),
            ex.Product(
                ex.Product(s2, ex.Sum(ex.Constant(1), ex.Negated(is_zero))),
                ex.Sum(out2, ex.Negated(ex.Sum(a2, ex.Negated(b2))))),
        ])
        return {"selector": sel, "a": a, "b": b, "c": c,
                "output": output, "value_inv": value_inv}

    def synthesize(self, config, layouter):
        a, b, c = self.a % FR, self.b % FR, self.c % FR

        def fn(region):
            region.enable_selector(config["selector"], 0)
            region.assign_advice(config["a"], 0, a)
            region.assign_advice(config["b"], 0, b)
            region.assign_advice(config["c"], 0, c)
            diff = (a - b) % FR
            inv = pow(diff, FR - 2, FR) if diff else 0
            region.assign_advice(config["value_inv"], 0, inv)
            output = c if a == b else diff
            region.assign_advice(config["output"], 0, output)

        layouter.assign_region("f(a, b, c) = if a == b {c} else {a - b}", fn)

    def instance_columns(self):
        return []


class MultiLookupCircuit:
    """standard-plonk chip with three log-derivative lookups, two sharing a
    table (reference: multi_lookup_circuit.h; halo2's plonk_api shape)."""

    A_DEFAULT = 0x76A69C75ED45F60E667FB401DD42F877B565F7818B1D94188FB67249

    def __init__(self, a=None, planner=SimpleFloorPlanner):
        self.a = self.A_DEFAULT if a is None else a
        self.instance = 2
        self.lookup_table = [2, self.a, self.a, 0]
        self._planner_cls = planner

    def floor_planner(self, cs, n):
        return self._planner_cls(cs, n)

    @staticmethod
    def configure(cs):
        e = cs.advice_column()
        a = cs.advice_column()
        b = cs.advice_column()
        sf = cs.fixed_column()
        c = cs.advice_column()
        d = cs.advice_column()
        p = cs.instance_column()
        cs.enable_equality(a)
        cs.enable_equality(b)
        cs.enable_equality(c)
        sm = cs.fixed_column()
        sa = cs.fixed_column()
        sb = cs.fixed_column()
        sc = cs.fixed_column()
        sp = cs.fixed_column()
        sl = cs.fixed_column()  # CreateLookupTableColumn
        dummy = cs.create_complex_selector()
        dummy_2 = cs.create_complex_selector()
        dummy_3 = cs.create_complex_selector()
        dummy_table = cs.fixed_column()  # CreateLookupTableColumn

        cs.lookup("lookup", [(cs.query(a, 0), cs.query(sl, 0))])
        cs.lookup("lookup_same", [(cs.query(a, 0), cs.query(sl, 0))])
        cs.lookup("lookup_same", [(
            ex.Product(
                ex.Product(ex.Product(dummy, dummy_2), dummy_3),
                cs.query(b, 0)),
            cs.query(dummy_table, 0))])

        d_n = cs.query(d, 1)
        a_q = cs.query(a, 0)
        sf_q = cs.query(sf, 0)
        e_p = cs.query(e, -1)
        b_q = cs.query(b, 0)
        c_q = cs.query(c, 0)
        sa_q = cs.query(sa, 0)
        sb_q = cs.query(sb, 0)
        sc_q = cs.query(sc, 0)
        sm_q = cs.query(sm, 0)
        poly = ex.Sum(
            ex.Sum(
                ex.Sum(
                    ex.Sum(ex.Product(a_q, sa_q), ex.Product(b_q, sb_q)),
                    ex.Product(ex.Product(a_q, b_q), sm_q)),
                ex.Negated(ex.Product(c_q, sc_q))),
            ex.Product(sf_q, ex.Product(d_n, e_p)))
        cs.create_gate("Combined add-mult", [poly])
        cs.create_gate("Public input", [
            ex.Product(cs.query(sp, 0),
                       ex.Sum(cs.query(a, 0), ex.Negated(cs.query(p, 0))))
        ])
        cs.enable_equality(sf)
        cs.enable_equality(e)
        cs.enable_equality(d)
        cs.enable_equality(p)
        cs.enable_equality(sm)
        cs.enable_equality(sa)
        cs.enable_equality(sb)
        cs.enable_equality(sc)
        cs.enable_equality(sp)
        return {"a": a, "b": b, "c": c, "d": d, "e": e, "sa": sa, "sb": sb,
                "sc": sc, "sf": sf, "sm": sm, "sp": sp, "sl": sl}

    def synthesize(self, config, layouter):
        a_val = self.a % FR
        a_sq = a_val * a_val % FR

        def public_input(region):
            region.assign_advice(config["a"], 0, self.instance)
            region.assign_fixed(config["sp"], 0, 1)

        layouter.assign_region("public_input", public_input)

        for _ in range(10):
            cells = {}

            def raw_multiply(region):
                cells["m_lhs"] = region.assign_advice(config["a"], 0, a_val)
                region.assign_advice(config["d"], 0,
                                     pow(a_val, 4, FR))
                cells["m_rhs"] = region.assign_advice(config["b"], 0, a_val)
                region.assign_advice(config["e"], 0, pow(a_val, 4, FR))
                cells["m_out"] = region.assign_advice(config["c"], 0, a_sq)
                region.assign_fixed(config["sa"], 0, 0)
                region.assign_fixed(config["sb"], 0, 0)
                region.assign_fixed(config["sc"], 0, 1)
                region.assign_fixed(config["sm"], 0, 1)

            layouter.assign_region("raw_multiply", raw_multiply)

            fin = (a_sq + a_val) % FR

            def raw_add(region):
                cells["a_lhs"] = region.assign_advice(config["a"], 0, a_val)
                region.assign_advice(config["d"], 0, pow(a_val, 4, FR))
                cells["a_rhs"] = region.assign_advice(config["b"], 0, a_sq)
                region.assign_advice(config["e"], 0, pow(a_sq, 4, FR))
                cells["a_out"] = region.assign_advice(config["c"], 0, fin)
                region.assign_fixed(config["sa"], 0, 1)
                region.assign_fixed(config["sb"], 0, 1)
                region.assign_fixed(config["sc"], 0, 1)
                region.assign_fixed(config["sm"], 0, 0)

            layouter.assign_region("raw_add", raw_add)

            def copy1(region):
                region.constrain_equal(cells["m_lhs"], cells["a_lhs"])
                region.constrain_equal(cells["m_lhs"], cells["a_lhs"])

            layouter.assign_region("copy", copy1)

            def copy2(region):
                region.constrain_equal(cells["a_rhs"], cells["m_out"])
                region.constrain_equal(cells["a_rhs"], cells["m_out"])

            layouter.assign_region("copy", copy2)

        def load_table(table):
            for i, v in enumerate(self.lookup_table):
                table.assign_cell(config["sl"], i, v % FR)

        layouter.assign_lookup_table("", load_table)

    def instance_columns(self):
        return [[self.instance]]


class ShuffleAPICircuit:
    """two-column shuffle via the shuffle argument API
    (reference: shuffle_api_circuit.h; log-derivative PS)."""

    def __init__(self, planner=SimpleFloorPlanner):
        self.input_0 = [1, 2, 4, 1]
        self.input_1 = [10, 20, 40, 10]
        self.shuffle_0 = [4, 1, 1, 2]
        self.shuffle_1 = [40, 10, 10, 20]
        self._planner_cls = planner

    def floor_planner(self, cs, n):
        return self._planner_cls(cs, n)

    @staticmethod
    def configure(cs):
        input_0 = cs.advice_column()
        input_1 = cs.fixed_column()
        shuffle_0 = cs.advice_column()
        shuffle_1 = cs.advice_column()
        s_shuffle = cs.create_complex_selector()
        s_input = cs.create_complex_selector()
        i0 = cs.query(input_0, 0)
        i1 = cs.query(input_1, 0)
        s0 = cs.query(shuffle_0, 0)
        s1 = cs.query(shuffle_1, 0)
        cs.shuffle("shuffle", [
            (ex.Product(s_input, i0), ex.Product(s_shuffle, s0)),
            (ex.Product(s_input, i1), ex.Product(s_shuffle, s1)),
        ])
        return {"input_0": input_0, "input_1": input_1,
                "shuffle_0": shuffle_0, "shuffle_1": shuffle_1,
                "s_input": s_input, "s_shuffle": s_shuffle}

    def synthesize(self, config, layouter):
        def load_inputs(region):
            for i, (v0, v1) in enumerate(zip(self.input_0, self.input_1)):
                region.assign_advice(config["input_0"], i, v0)
                region.assign_fixed(config["input_1"], i, v1)
                region.enable_selector(config["s_input"], i)

        layouter.assign_region("load inputs", load_inputs)

        def load_shuffles(region):
            for i, (v0, v1) in enumerate(zip(self.shuffle_0, self.shuffle_1)):
                region.assign_advice(config["shuffle_0"], i, v0)
                region.assign_advice(config["shuffle_1"], i, v1)
                region.enable_selector(config["s_shuffle"], i)

        layouter.assign_region("load shuffles", load_shuffles)

    def instance_columns(self):
        return []


class ShuffleCircuit:
    """W-column H-row shuffle proven manually with phase challenges: theta
    and gamma are squeezed after first-phase advice, z lives in the second
    phase (reference: shuffle_circuit.h; kW=2, kH=8)."""

    W, H = 2, 8

    def __init__(self, original=None, shuffled=None,
                 planner=SimpleFloorPlanner):
        # keygen uses the witness-free dummy tables (WithoutWitness)
        zero = [[0] * self.H for _ in range(self.W)]
        self.original = original if original is not None else zero
        self.shuffled = shuffled if shuffled is not None else zero
        self._planner_cls = planner

    def floor_planner(self, cs, n):
        return self._planner_cls(cs, n)

    @classmethod
    def configure(cls, cs):
        q_shuffle = cs.create_simple_selector()
        q_first = cs.create_simple_selector()
        q_last = cs.create_simple_selector()
        original = [cs.advice_column() for _ in range(cls.W)]
        shuffled = [cs.advice_column() for _ in range(cls.W)]
        theta = cs.challenge_usable_after(0)
        gamma = cs.challenge_usable_after(0)
        z = cs.advice_column(phase=1)

        qf = cs.query_selector(q_first)
        zq = cs.query(z, 0)
        cs.create_gate("z should start with 1", [
            ex.Product(qf, ex.Sum(ex.Constant(1), ex.Negated(zq)))])
        ql = cs.query_selector(q_last)
        cs.create_gate("z should end with 1", [
            ex.Product(ql, ex.Sum(ex.Constant(1), ex.Negated(zq)))])

        qs = cs.query_selector(q_shuffle)
        orig_q = [cs.query(c, 0) for c in original]
        shuf_q = [cs.query(c, 0) for c in shuffled]
        z_w = cs.query(z, 1)
        orig_acc = orig_q[0]
        for e in orig_q[1:]:
            orig_acc = ex.Sum(ex.Product(orig_acc, theta), e)
        shuf_acc = shuf_q[0]
        for e in shuf_q[1:]:
            shuf_acc = ex.Sum(ex.Product(shuf_acc, theta), e)
        cs.create_gate("z should have valid transition", [
            ex.Product(qs, ex.Sum(
                ex.Product(zq, ex.Sum(orig_acc, gamma)),
                ex.Negated(ex.Product(z_w, ex.Sum(shuf_acc, gamma)))))])
        return {"q_shuffle": q_shuffle, "q_first": q_first, "q_last": q_last,
                "original": original, "shuffled": shuffled,
                "theta": theta, "gamma": gamma, "z": z}

    def synthesize(self, config, layouter):
        H, W = self.H, self.W
        theta = layouter.get_challenge(config["theta"])
        gamma = layouter.get_challenge(config["gamma"])

        def fn(region):
            region.enable_selector(config["q_first"], 0)
            region.enable_selector(config["q_last"], H)
            for i in range(H):
                region.enable_selector(config["q_shuffle"], i)
            for i in range(W):
                for j in range(H):
                    region.assign_advice(config["original"][i], j,
                                         self.original[i][j] % FR)
            for i in range(W):
                for j in range(H):
                    region.assign_advice(config["shuffled"][i], j,
                                         self.shuffled[i][j] % FR)
            if theta is not None and gamma is not None:
                z = [1]
                for i in range(H):
                    num, den = 0, 0
                    for col in self.original:
                        num = (num * theta + col[i]) % FR
                    for col in self.shuffled:
                        den = (den * theta + col[i]) % FR
                    ratio = (num + gamma) * pow(
                        (den + gamma) % FR, FR - 2, FR) % FR
                    z.append(z[-1] * ratio % FR)
                for i in range(H + 1):
                    region.assign_advice(config["z"], i, z[i])
            else:
                for i in range(H + 1):
                    region.assign_advice(config["z"], i, 0)

        layouter.assign_region("Shuffle original into shuffled", fn)

    def instance_columns(self):
        return []

"""tachyon_tpu_torch/base/profiler.py: the JAX package's categories and API,
spans recorded only while a profiler is active, and a chrome trace that
holds them; on CPU."""
import json

import pytest
import torch

from tachyon_tpu.base import profiler as jprof
from tachyon_tpu_torch.base import profiler

CATEGORIES = ("CATEGORY_UTILS", "CATEGORY_SUBTASK", "CATEGORY_MSM", "CATEGORY_NTT",
              "CATEGORY_PROOF_GENERATION", "CATEGORY_PROOF_VERIFICATION")


def test_categories_are_the_jax_ones():
    assert {c: getattr(profiler, c) for c in CATEGORIES} == {c: getattr(jprof, c)
                                                            for c in CATEGORIES}


def test_spans_only_while_active():
    profiler._events.clear()
    with profiler.trace_event(profiler.CATEGORY_MSM, "idle"):
        pass
    assert profiler._events == []
    with profiler.collect_events() as ev:
        with profiler.trace_event(profiler.CATEGORY_MSM, "msm"):
            with profiler.trace_event(profiler.CATEGORY_NTT, "fft"):
                torch.ones(4).sum()
    assert [(c, n) for c, n, _, _ in ev] == [("EvaluationDomain", "fft"), ("MSM", "msm")]
    assert all(t1 >= t0 for _, _, t0, t1 in ev)
    assert not profiler._active
    with profiler.trace_event(profiler.CATEGORY_MSM, "after"):
        pass
    assert [n for _, n, _, _ in profiler._events] == ["fft", "msm"]


def test_profiler_writes_chrome_trace(tmp_path):
    path = tmp_path / "trace.json"
    with profiler.Profiler(str(path), device="cpu"):
        assert profiler._active
        with profiler.trace_event(profiler.CATEGORY_PROOF_GENERATION, "groth16_prove"):
            torch.arange(64).reshape(8, 8).sum()
    assert not profiler._active
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "ProofGeneration/groth16_prove" in names


def test_cuda_profiler_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiler.Profiler("unused.json")

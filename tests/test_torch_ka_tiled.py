"""The checks ``chip_smoke.py`` and the card tests hold KA's bf16 tiled form
to, on the CPU at a small size: ``tiled_fault_twin`` with no fault is
bitwise the plain forward and backward, and ``tiled_f64_accuracy`` passes
the bf16 plain version against float64 while rejecting the twin with its
mask faulted on the last key tile (``tiled_fault_t0``: causal, those keys
escape it; else the last 64 keys dropped)."""

import numpy as np
import pytest
import torch

import chip_smoke
from sitewhere_tpu_torch.models import common as tc


def _inputs(n, t, heads, hd, seed=7):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.normal(size=(n, t, heads * hd)) * 1.5).astype(np.float32))
            .to(torch.bfloat16) for _ in range(4)]


@pytest.mark.parametrize("causal", [True, False])
def test_fault_twin_without_fault_is_the_plain_version(causal):
    q, k, v, do = _inputs(2, 19, 2, 8)
    out, grads = chip_smoke.tiled_fault_twin(q, k, v, do, 2, causal, 19)
    assert torch.equal(out, tc.attention_plain(q, k, v, 2, causal))
    for a, b in zip(grads, tc.attention_bwd_plain(q, k, v, do, 2, causal)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("causal", [True, False])
def test_f64_accuracy_rejects_the_faulted_twin(causal):
    n, t, heads, hd = 2, 70, 2, 16
    q, k, v, do = _inputs(n, t, heads, hd, seed=8)
    plain = (tc.attention_plain(q, k, v, heads, causal),
             *tc.attention_bwd_plain(q, k, v, do, heads, causal))
    w = [x.double() for x in (q, k, v, do)]
    ref = (tc.attention_plain(*w[:3], heads, causal), *tc.attention_bwd_plain(*w, heads, causal))
    assert chip_smoke.tiled_f64_accuracy(plain, plain, ref)["ok"]
    t0 = chip_smoke.tiled_fault_t0(t, causal)
    fo, fg = chip_smoke.tiled_fault_twin(q, k, v, do, heads, causal, t0)
    assert not chip_smoke.tiled_f64_accuracy((fo, *fg), plain, ref)["ok"]

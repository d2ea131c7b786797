"""The checks ``chip_smoke.py`` and the card tests hold KA's bf16 split form
to, on the CPU at a small size: ``tiled_f64_accuracy`` passes the bf16
plain version against float64 and rejects both split fault twins, each
chunk's block forming its logits from its own columns
(``attention_own_columns_fault``) and the mask faulted from
``tiled_fault_t0`` (``tiled_fault_twin``); and ``attn_split_plan``, the
launch geometry of the bf16 kernels, on its edges: head dims around the
64-column chunks, T at the packing, one-tile and cache boundaries."""

import numpy as np
import pytest
import torch

import chip_smoke
from sitewhere_tpu_torch import kernels
from sitewhere_tpu_torch.models import common as tc


def _inputs(n, t, heads, hd, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.normal(size=(n, t, heads * hd)) * 1.5).astype(np.float32))
            .to(torch.bfloat16) for _ in range(4)]


@pytest.mark.parametrize("hd, t, causal", [(288, 31, True), (300, 31, True), (288, 40, False),
                                           (300, 40, False)])
def test_f64_accuracy_rejects_both_split_faults(hd, t, causal):
    n, heads = 2, 1
    q, k, v, do = _inputs(n, t, heads, hd, seed=hd + t)
    plain = (tc.attention_plain(q, k, v, heads, causal),
             *tc.attention_bwd_plain(q, k, v, do, heads, causal))
    w = [x.double() for x in (q, k, v, do)]
    ref = (tc.attention_plain(*w[:3], heads, causal), *tc.attention_bwd_plain(*w, heads, causal))
    assert chip_smoke.tiled_f64_accuracy(plain, plain, ref)["ok"]
    fo, fg = chip_smoke.attention_own_columns_fault(q, k, v, heads, causal, do)
    assert torch.equal(fo, chip_smoke.attention_own_columns_fault(q, k, v, heads, causal))
    assert not chip_smoke.tiled_f64_accuracy((fo, *fg), plain, ref)["ok"]
    t0 = chip_smoke.tiled_fault_t0(t, causal)
    fo, fg = chip_smoke.tiled_fault_twin(q, k, v, do, heads, causal, t0)
    assert not chip_smoke.tiled_f64_accuracy((fo, *fg), plain, ref)["ok"]


@pytest.mark.parametrize("hd, chunks, copy", [(257, 5, 2), (511, 8, 2), (512, 8, 16),
                                              (513, 9, 2), (300, 5, 8), (258, 5, 4)])
def test_split_plan_head_dims(hd, chunks, copy):
    plan = tc.attn_split_plan(31, hd)
    assert plan["depth_chunks"] == chunks and plan["copy_bytes"] == copy
    assert (plan["rows_per_item"], plan["items_per_block"], plan["tiles"]) == (32, 2, 1)


@pytest.mark.parametrize("t, rows, items, tiles", [(1, 8, 8, 1), (8, 8, 8, 1), (9, 16, 4, 1),
                                                   (32, 32, 2, 1), (33, 64, 1, 1),
                                                   (64, 64, 1, 1), (65, 64, 1, 2),
                                                   (197, 64, 1, 4)])
def test_split_plan_tiles(t, rows, items, tiles):
    plan = tc.attn_split_plan(t, 512)
    assert (plan["rows_per_item"], plan["items_per_block"], plan["tiles"]) == (rows, items, tiles)
    fused = tiles == 1
    assert plan["bwd_kernels"] == (("attention_split_bwd_tc",) if fused else
                                   ("attention_split_dq_tc", "attention_split_dkv_tc"))
    # a ring of 4 stages of two 8 KB tiles, then one p tile a key tile
    assert plan["fwd_smem"] == 65536 + 8192 * tiles
    assert plan["bwd_smem"] == ((9 * 8192,) if fused else
                                (65536 + 8192 * tiles, 65536 + 2 * 8192 * tiles))


@pytest.mark.parametrize("t, fwd, dq, dkv", [(640, True, True, True), (641, True, True, False),
                                             (1280, True, True, False),
                                             (1281, False, False, False)])
def test_split_plan_cache_boundaries(t, fwd, dq, dkv):
    plan = tc.attn_split_plan(t, 320)
    assert plan["fwd_resident"] == fwd and plan["bwd_resident"] == (dq, dkv)
    assert max(plan["fwd_smem"], *plan["bwd_smem"]) <= kernels.SMEM_MAX_BYTES

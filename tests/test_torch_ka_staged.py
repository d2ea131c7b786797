"""The checks ``chip_smoke.py`` and the card tests hold the bf16 staged KA
(``csrc/attention.cu``, ``attention_bwd.cu`` on tensor cores) to, on the CPU
at a small size: ``attn_staged_plan``, the launch geometry of its kernels,
at the boundary T of the packing and the tiles; the caps that mirror its
shared memory; and the two faults the float64 check must reject: the packed
tile's block-diagonal mask dropped between two items
(``staged_pack_fault_twin``, which without the fault is the plain version)
and a causal leak (``tiled_fault_twin``)."""

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


# T -> (rows an item takes in a packed tile, items a tile); None: staged
PACKING = {1: (8, 8), 8: (8, 8), 16: (16, 4), 17: (32, 2), 31: (32, 2), 32: (32, 2),
           33: (64, 1), 64: (64, 1), 65: None, 128: None, 197: None, 391: None, 512: None}


@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("t", sorted(PACKING))
def test_staged_plan_geometry(t, hd):
    plan = tc.attn_staged_plan(t, hd)
    tile = 64 * hd * 2  # one bf16 tile of 64 rows
    assert plan["warpgroups"] == 2
    if PACKING[t] is not None:
        rows, items = PACKING[t]
        assert plan["packed"] and plan["query_tiles"] == 1
        assert (plan["rows_per_item"], plan["items_per_tile"]) == (rows, items)
        assert plan["items_per_block"] == 2 * items
        # two stages of q, k, v (and dout) tiles of both warpgroups; p^T and
        # dl^T tiles of 64 x 64 a warpgroup
        assert plan["fwd_smem"] == 2 * 3 * 2 * tile
        assert plan["bwd_smem"] == 2 * 4 * 2 * tile + 2 * 2 * 8192
        assert (plan["fwd_kernel"], plan["bwd_kernel"]) == ("attention_staged_pack_tc",
                                                            "attention_staged_bwd_pack_tc")
    else:
        tiles = -(-t // 64)
        assert not plan["packed"] and plan["query_tiles"] == tiles
        assert (plan["items_per_tile"], plan["items_per_block"]) == (1, 1)
        assert plan["fwd_smem"] == 3 * tiles * tile
        assert plan["bwd_smem"] == (-(-t // 8) * 8 + 3 * 64 * tiles) * hd * 2 + 16 * 64 * tiles
        assert (plan["fwd_kernel"], plan["bwd_kernel"]) == ("attention_staged_tc",
                                                            "attention_staged_bwd_tc")
    assert plan["fwd_smem"] <= kernels.SMEM_MAX_BYTES
    assert (plan["bwd_smem"] <= kernels.SMEM_MAX_BYTES) == (t <= (512 if hd == 32 else 416))


def test_bf16_caps_follow_the_plan():
    """The bf16 caps come from the plan's shared memory: the forward takes
    T up to 512 at both head dims, the backward 512 at hd 32 and 416 at hd
    64 (the CUDA-core form took 391), ViT-B/16's T 197 and the transformer's
    T 31 stay staged both ways."""
    bf16 = torch.bfloat16
    assert tc.attn_max_t(False, bf16, 32) == tc.attn_max_t(False, bf16, 64) == 512
    assert tc.attn_max_t(True, bf16, 32) == 512 and tc.attn_max_t(True, bf16, 64) == 416
    assert tc.attn_smem_bytes(True, bf16, 64, 416) == kernels.SMEM_MAX_BYTES
    for backward in (False, True):
        assert tc.attn_route(backward, bf16, 64, 197) == tc.attn_route(backward, bf16, 32, 31) \
            == "staged"
    assert tc.attn_route(True, bf16, 64, 417) == "tiled"


@pytest.mark.parametrize("t, causal", [(8, True), (17, False), (31, True), (32, False)])
def test_pack_fault_twin_without_the_fault_is_the_plain_version(t, causal):
    q, k, v, do = _inputs(2, t, 3, 32, seed=t)
    out, grads = chip_smoke.staged_pack_fault_twin(q, k, v, do, 3, causal, leak=False)
    assert torch.equal(out, tc.attention_plain(q, k, v, 3, causal))
    for a, b in zip(grads, tc.attention_bwd_plain(q, k, v, do, 3, causal)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("t, causal", [(8, True), (17, False), (31, True), (31, False)])
def test_f64_accuracy_rejects_the_packed_leak_and_the_causal_leak(t, causal):
    n, heads, hd = 2, 4, 32
    q, k, v, do = _inputs(n, t, heads, hd, seed=100 + t)
    plain = (tc.attention_plain(q, k, v, heads, causal),
             *tc.attention_bwd_plain(q, k, v, do, heads, causal))
    w = [x.double() for x in (q, k, v, do)]
    ref = (tc.attention_plain(*w[:3], heads, causal), *tc.attention_bwd_plain(*w, heads, causal))
    assert chip_smoke.tiled_f64_accuracy(plain, plain, ref)["ok"]
    fo, fg = chip_smoke.staged_pack_fault_twin(q, k, v, do, heads, causal)
    assert not chip_smoke.tiled_f64_accuracy((fo, *fg), plain, ref)["ok"]
    if causal:
        fo, fg = chip_smoke.tiled_fault_twin(q, k, v, do, heads, causal,
                                             chip_smoke.tiled_fault_t0(t, causal))
        assert not chip_smoke.tiled_f64_accuracy((fo, *fg), plain, ref)["ok"]

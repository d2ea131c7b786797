"""Port parity of the transformer on bf16 and int8 serving weights and of
attention at any head dim and length: the plain versions behind KE and KN's
weight formats, KQ (the int8 dequant) and KA's tiled forward and backward,
on the CPU against the JAX package on the same numpy inputs.

Bars, each the reference's own or stated here:

- ``score_stacked`` and the flush form ``tf_score`` on ``quantize_params``
  trees: f32 compute 2e-4 (``tests/test_fused_step.py:144``); bf16 compute
  by accuracy, the port's mean abs error against the reference's f32
  scores at most 1.25x the reference's own bf16 error + 1e-3 (two bf16
  computations of the NLL differ past 2e-2 on a few rows, ROADMAP queue 3);
- the scorer with ``param_dtype`` "bf16" / "int8" against the reference's,
  f32 compute: window state bitwise, scores at 2e-4; every stream takes the
  same number of rows a flush (the reference's ``_segment_ranks`` fault,
  ROADMAP queue 3);
- KQ's plain form bitwise the reference's ``kernel_weight``;
- ``attention_plain`` and ``attention_bwd_plain`` against ``attn_core`` and
  its ``jax.vjp``: f32 2e-4 (forward) and rtol 1e-4 / atol 1e-5 of the
  largest value (backward, ``tests/test_train_lane.py:119-124``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sitewhere_tpu.models as jm
import sitewhere_tpu.models.common as jc
import sitewhere_tpu.parallel.sharded as js
import sitewhere_tpu_torch.models as tm
import sitewhere_tpu_torch.models.common as tc
import sitewhere_tpu_torch.models.transformer as tt
from sitewhere_tpu.parallel.mesh import MeshManager as JMesh
from sitewhere_tpu_torch.ops.windows import WindowState
from sitewhere_tpu_torch.parallel.mesh import MeshManager
from sitewhere_tpu_torch.parallel.sharded import ShardedScorer

S, B, W = 3, 8, 12
SMALL = {"context": 16, "dim": 32, "depth": 2, "heads": 2, "horizon": 3}

# tiny tensors: one intra-op thread, so the suite's parallel workers keep
# their cores
torch.set_num_threads(1)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _configs(dtype):
    over = dict(SMALL, dtype=dtype)
    return jm.make_config("transformer", over), tm.make_config("transformer", over)


def _stacked(seed=0, n=S):
    """n JAX transformer trees with non-zero biases and LayerNorm affines
    off their init, stacked, as numpy."""
    jcfg, _ = _configs("float32")
    rng = np.random.default_rng(300 + seed)

    def jiggle(path, x):
        name = jax.tree_util.keystr(path)
        if name.endswith("['b']") or name.endswith("['bias']"):
            return rng.normal(scale=0.1, size=x.shape).astype(np.float32)
        if name.endswith("['scale']"):
            return (1.0 + rng.normal(scale=0.1, size=x.shape)).astype(np.float32)
        return x

    trees = [jax.tree_util.tree_map_with_path(
        jiggle, _np_tree(jm.get_model("transformer").init(jax.random.PRNGKey(10 * seed + i),
                                                          jcfg)))
        for i in range(n)]
    return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *trees)


def _windows(seed):
    rng = np.random.default_rng(seed)
    wins = rng.normal(size=(S, B, W)).astype(np.float32)
    wins[1] = np.cumsum(wins[1], -1)
    nv = np.full((S, B), W, np.int32)
    nv[0, :3] = [0, 3, 5]
    return wins, nv


def _quantized(stacked, pd):
    jq = jc.quantize_params(jax.tree_util.tree_map(jnp.asarray, stacked), pd)
    return jq, tc.quantize_params(tc.params_from_numpy(stacked, "cpu"), pd)


@functools.lru_cache(maxsize=None)
def _jit_score(k):
    return jax.jit(jm.transformer.score_stacked, static_argnums=(1, 4))


def _accurate(got, ref_bf16, ref_f32):
    ek = float(np.abs(got - ref_f32).mean())
    er = float(np.abs(ref_bf16 - ref_f32).mean())
    assert ek <= 1.25 * er + 1e-3, (ek, er)


def _flush_case(seed, k):
    """Rings of random walks, ids with repeats, ``later`` and a counts mask:
    (the port's state, ids, later, active, counts; the windows and n_valid
    each row reads, from the port's own gather)."""
    rng = np.random.default_rng(seed)
    streams = 20
    state = WindowState(
        torch.from_numpy(np.cumsum(rng.normal(size=(S, streams, W)), -1).astype(np.float32)),
        torch.from_numpy(rng.integers(0, W, (S, streams)).astype(np.int32)),
        torch.from_numpy(rng.integers(0, 2 * W, (S, streams)).astype(np.int32)),
    )
    ids = torch.from_numpy(rng.integers(0, streams, (S, B)).astype(np.int32))
    later = torch.from_numpy(rng.integers(0, k + 1, (S, B)).astype(np.int32))
    active = torch.tensor([True, True, False])
    counts = torch.tensor([[B], [5], [B]], dtype=torch.int32)
    wins, nv = tm.flush.gather_stacked(state, ids)
    return state, ids, later, active, counts, wins.numpy(), nv.numpy()


@pytest.mark.parametrize("param_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_score_stacked_and_flush_match_reference(dtype, param_dtype):
    """The port's ``score_stacked`` (K 1 and 3) and ``tf_score`` (the flush
    form, its column select and row mask) on the same ``quantize_params``
    tree as the reference's ``score_stacked``, through the plain versions
    and through the kernel path's composition on CPU tensors."""
    jcfg, tcfg = _configs(dtype)
    jq, tq = _quantized(_stacked(), param_dtype)
    wins, nv = _windows(11)
    want = np.asarray(_jit_score(3)(jq, jcfg, jnp.asarray(wins), jnp.asarray(nv), 3))
    f32 = None
    if dtype == "bfloat16":
        jf32, _ = _configs("float32")
        f32 = np.asarray(_jit_score(3)(jq, jf32, jnp.asarray(wins), jnp.asarray(nv), 3))
    for k in (3, 1):
        for got in (tt.score_stacked(tq, tcfg, torch.from_numpy(wins), torch.from_numpy(nv), k=k),
                    tt._score_stacked(tq, tcfg, torch.from_numpy(wins), torch.from_numpy(nv), k,
                                      tt.KERNEL_OPS)):
            got = got.numpy()
            assert got.shape == (S, B, k)
            np.testing.assert_array_equal(got == 0.0, want[..., 3 - k:] == 0.0)
            if f32 is None:
                np.testing.assert_allclose(got, want[..., 3 - k:], rtol=2e-4, atol=2e-4)
            else:
                _accurate(got, want[..., 3 - k:], f32[..., 3 - k:])
    # the flush form on rows gathered from rings
    state, ids, later, active, counts, fw, fnv = _flush_case(12, 3)
    col = np.clip(2 - later.numpy(), 0, 2)
    live = active.numpy()[:, None] & (np.arange(B)[None] < counts.numpy())

    def select(sk):
        return np.where(live, np.take_along_axis(sk, col[..., None], -1)[..., 0], 0.0)

    got = tt.tf_score(tq, tcfg, state, ids, later, active, counts=counts, k=3).numpy()
    # the flush form is score_stacked on the gathered rows plus the select:
    # bitwise the port's own; against the reference at the f32 bar (bf16's
    # accuracy is held above, over every row and column)
    np.testing.assert_array_equal(got, select(tt.score_stacked(
        tq, tcfg, torch.from_numpy(fw), torch.from_numpy(fnv), k=3).numpy()))
    ref = select(np.asarray(_jit_score(3)(jq, jcfg, jnp.asarray(fw), jnp.asarray(fnv), 3)))
    np.testing.assert_array_equal(got == 0.0, ref == 0.0)
    if f32 is None:
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def test_kq_plain_is_the_reference_dequant():
    """KQ's plain version (``kernel_weight`` on an int8 node, and
    ``dequant_plain``) bitwise the reference's ``kernel_weight`` on the
    same tree, bf16 and f32, for every dense node of a transformer tree."""
    jq, tq = _quantized(_stacked(seed=1), "int8")
    jnodes = [jq["embed"], jq["head"]] + [b[g][n] for b in jq["blocks"]
                                          for g, n in (("attn", "wq"), ("attn", "wo"),
                                                       ("mlp", "fc1"), ("mlp", "fc2"))]
    tnodes = [tq["embed"], tq["head"]] + [b[g][n] for b in tq["blocks"]
                                          for g, n in (("attn", "wq"), ("attn", "wo"),
                                                       ("mlp", "fc1"), ("mlp", "fc2"))]
    for jn, tn in zip(jnodes, tnodes):
        np.testing.assert_array_equal(tn["qw"].numpy(), np.asarray(jn["qw"]))
        for tdt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
            want = np.asarray(jc.kernel_weight(jn, jdt).astype(jnp.float32))
            got = tc.kernel_weight(tn, tdt)
            np.testing.assert_array_equal(got.float().numpy(), want)
            assert torch.equal(tc.dequant_weight(tn, tdt), got)  # CPU: the plain form
            assert torch.equal(tc.dequant(tn["qw"], tn["scale"], tdt), got)


def test_per_tenant_score_and_forecast_read_w_as_the_reference():
    """The per-tenant ``score`` and ``forecast`` read each dense layer's
    ``w``, as the reference's ``dense``: a bf16 tree scores as the
    reference's does on it; an int8 tree raises, as the reference's fails
    (no ``w``)."""
    jcfg, tcfg = _configs("float32")
    one = jax.tree_util.tree_map(lambda x: x[0], _stacked(seed=2, n=1))
    jq, tq = _quantized(one, "bf16")
    wins, nv = _windows(13)
    wins, nv = wins.reshape(-1, W), nv.reshape(-1)
    want = np.asarray(jm.transformer.score(jq, jcfg, jnp.asarray(wins), jnp.asarray(nv)))
    got = tt.score(tq, tcfg, torch.from_numpy(wins), torch.from_numpy(nv)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    with pytest.raises(KeyError):
        jm.transformer.score(_quantized(one, "int8")[0], jcfg, jnp.asarray(wins), jnp.asarray(nv))
    i8 = _quantized(one, "int8")[1]
    with pytest.raises(ValueError, match="reads each dense layer's w"):
        tt.score(i8, tcfg, torch.from_numpy(wins), torch.from_numpy(nv))
    with pytest.raises(ValueError, match="reads each dense layer's w"):
        tt.forecast(i8, tcfg, torch.from_numpy(wins), eps=torch.zeros((3, wins.shape[0])))
    samples, _ = tt.forecast(tq, tcfg, torch.from_numpy(wins), eps=torch.zeros((3, wins.shape[0])))
    assert bool(torch.isfinite(samples).all())


# -- the scorer on quantized serving weights -----------------------------------------

T_SLOTS, LANE, STREAMS = 2, 32, 64


@pytest.mark.parametrize("param_dtype, k", [("int8", 1), ("bf16", 1), ("int8", 3)])
def test_quantized_scorer_matches_reference(param_dtype, k):
    """``ShardedScorer(family="transformer", param_dtype=...)`` (the plain
    flush on the CPU, the same quantized view the card serves) against the
    reference's scorer, f32 compute, K 1 and 3: window state bitwise,
    scores at 2e-4 over 4 flushes in which every stream takes two rows."""
    over = dict(SMALL, depth=1, window=W, dtype="float32")
    jsc = js.ShardedScorer(
        JMesh(tenant=1, data=1, devices=jax.devices()[:1]), jm.get_model("transformer"),
        jm.make_config("transformer", over), slots_per_shard=T_SLOTS, max_streams=STREAMS,
        window=W, fuse_k=k, param_dtype=param_dtype)
    tsc = ShardedScorer(
        MeshManager(device="cpu"), tm.get_model("transformer"), tm.make_config("transformer", over),
        slots_per_shard=T_SLOTS, max_streams=STREAMS, window=W, fuse_k=k,
        param_dtype=param_dtype, base_params=_np_tree(jsc._base_params))
    assert jsc.param_dtype == tsc.param_dtype == param_dtype
    for sc in (jsc, tsc):
        for slot in range(T_SLOTS):
            sc.activate(slot)
    rng = np.random.default_rng(90 + k)
    for _ in range(4):
        ids = np.stack([rng.permutation(np.repeat(rng.choice(STREAMS, LANE // 2, replace=False),
                                                  2)) for _ in range(T_SLOTS)])
        ids = ids.astype(tsc.ids_np_dtype)
        vals = rng.normal(size=(T_SLOTS, LANE)).astype(np.float32)
        counts = np.full((T_SLOTS, 1), LANE, np.int32)
        want = np.asarray(jsc.step_counts(*jsc.stage_inputs(ids, vals, counts)))
        got = tsc.step_counts(*tsc.stage_inputs(ids, vals, counts)).numpy_f32()
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
        for a, b in zip(tsc.state, jsc.state):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert np.any(got != 0.0)
    assert tsc.flops_per_flush(LANE) == jsc.flops_per_flush(LANE)


# -- attention at any head dim and length ----------------------------------------------

@pytest.mark.parametrize("n, t, heads, hd, causal", [
    (2, 11, 2, 8, True), (2, 15, 2, 16, False), (1, 530, 1, 80, True), (1, 520, 1, 128, False),
])
def test_attention_plain_forms_match_reference(n, t, heads, hd, causal):
    """``attention_plain`` and ``attention_bwd_plain`` (the plain versions
    of both KA forms) against ``attn_core`` and its ``jax.vjp`` at head dims
    8, 16, 80 and 128, T past 512 at a tiny batch, f32."""
    rng = np.random.default_rng(t + hd)
    q, k, v, do = (rng.normal(size=(n, t, heads * hd)).astype(np.float32) for _ in range(4))

    def split(a):
        return jnp.asarray(a).reshape(n, t, heads, hd)

    def core(q_, k_, v_):
        return jc.attn_core(q_, k_, v_, causal, jnp.float32)

    want, vjp = jax.vjp(core, split(q), split(k), split(v))
    got = tc.attention_plain(*(torch.from_numpy(a) for a in (q, k, v)), heads, causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    grads = tc.attention_bwd_plain(*(torch.from_numpy(a) for a in (q, k, v, do)), heads, causal)
    for g, w in zip(grads, vjp(jnp.asarray(do))):
        w = np.asarray(w).reshape(n, t, heads * hd)
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5 * scale)
    # the tiled form's wrappers take the plain versions on CPU tensors
    assert torch.equal(tc.attention_tiled(*(torch.from_numpy(a) for a in (q, k, v)), heads,
                                          causal), got)


def test_attention_route_is_a_function_of_shape():
    """``attn_route`` by (direction, dtype, hd, T): the staged form keeps
    head dims 32 and 64 up to its shared-memory caps, the tiled form takes
    the rest up to head dim 256, the split form every wider head (before
    it, they raised naming K3'c)."""
    f32, bf16 = torch.float32, torch.bfloat16
    for backward in (False, True):
        for dtype in (f32, bf16):
            for hd in (32, 64):
                cap = tc.attn_max_t(backward, dtype, hd)
                assert tc.attn_route(backward, dtype, hd, 1) == "staged"
                assert tc.attn_route(backward, dtype, hd, cap) == "staged"
                assert tc.attn_route(backward, dtype, hd, cap + 1) == "tiled"
            for hd in (1, 8, 16, 48, 80, 128, 256):
                assert tc.attn_route(backward, dtype, hd, 7) == "tiled"
            for hd in (257, 288, 300, 512, 4096):
                assert tc.attn_route(backward, dtype, hd, 7) == "split"
    # the shapes of the main paths: the transformer's T 31 and ViT-B/16's
    # T 197 stay staged; ViT-B/16 at 384 (T 577) and ViT-H/14 (hd 80) tile
    assert tc.attn_route(False, bf16, 32, 31) == tc.attn_route(True, bf16, 32, 31) == "staged"
    assert tc.attn_route(False, bf16, 64, 197) == tc.attn_route(True, f32, 64, 197) == "staged"
    assert tc.attn_route(False, bf16, 64, 577) == tc.attn_route(True, bf16, 64, 577) == "tiled"
    assert tc.attn_route(False, bf16, 80, 257) == "tiled"

"""The port's CUDA kernels against their plain PyTorch versions, on
the card. Every test here is marked ``cuda`` and skips without a GPU; on a
machine with one (and no JAX) run them with

    python -m pytest --noconftest -q tests/test_torch_kernels.py

(``--noconftest``: the suite's conftest configures JAX). KW, KH and KG are
held bitwise; KS, KD, KF and the transformer's KE, KL, KA, KU, KN within
the bf16 bar 2e-2 (``tests/test_fused_step.py:110``). The train kernels: KB
and KR's f32 gradients per element at the reference's train bars (rtol
1e-4, atol 1e-5, ``tests/test_train_lane.py:121``), their bf16 gradients
within 2e-2 relative norm of the f32 plain gradient; KO within one f32 ulp
of its plain version (bitwise but for the plain version's float64 FMA
emulation's double rounding). The recurrent kernels' widths (hidden 8,
16, 32, 64) and KS/KD's weight formats (f32, bf16, int8) are held at 2e-4
in f32 compute and 2e-2 in bf16, bf16 storage bitwise the f32 masters.
Since K3'c's serving half: KW's multi-block form bitwise the plain version
and the one-block form; KS, KD and KF's wide forms (any hidden, window and
sample count) at the same bars as their templated forms. The attention
families past their caps: KE's raw form (histories of any length), KA's
split form forward and
backward (head dims past 256) and KT's sort (top-k past 64) and bf16-weight
forms against their plain versions. K14: KA's ring step (the block
attention of ring attention, in place on the running softmax statistics)
within 2e-4 of its plain version in every mask regime of the causal ring.
KA's tiled form in bf16 (tensor cores) also at its tiles' edges and by its
mean error against float64, a faulted twin shown failing that check.
``chip_smoke.py`` runs the same comparisons at the main path's shapes."""

import dataclasses

import numpy as np
import pytest
import torch

from sitewhere_tpu_torch import kernels
from sitewhere_tpu_torch.models import get_model, make_config
from sitewhere_tpu_torch.models import common as tc
from sitewhere_tpu_torch.models import deepar, lstm_ad
from sitewhere_tpu_torch.models import train as tm_train
from sitewhere_tpu_torch.models import transformer as tt
from sitewhere_tpu_torch.models import vit as tv
from sitewhere_tpu_torch.ops import adam
from sitewhere_tpu_torch.ops import dct as td
from sitewhere_tpu_torch.ops import windows as tw
from sitewhere_tpu_torch.parallel.mesh import MeshManager
from sitewhere_tpu_torch.parallel.sharded import (
    ShardedScorer,
    f32_to_bf16_bits,
    gather_rows,
    gather_rows_plain,
    score_sketch,
    score_sketch_plain,
)
from sitewhere_tpu_torch.sim import media as tsim

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels build and run only "
                    "on the card (python3 chip_smoke.py runs these checks there)")
    return torch.device("cuda")


def _on(dev, a):
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).to(dev).view(torch.uint16)
    return torch.from_numpy(a).to(dev)


@pytest.mark.parametrize("id_dtype", [np.int32, np.uint16])
def test_kw_matches_plain(dev, id_dtype):
    rng = np.random.default_rng(4)
    t, s, w, b = 4, 512, 8, 300
    st_k = tw.init_window_state(s, w, device=dev, n_slots=t)
    st_p = tw.init_window_state(s, w, device=dev, n_slots=t)
    for f in range(6):
        ids = rng.integers(0, 40, (t, b))
        ids[0, :50] = 7               # a burst far past the window
        ids[1, 3] = s + 5             # out of range: dropped, never read
        ids = _on(dev, ids.astype(id_dtype))
        vals = _on(dev, rng.normal(size=(t, b)).astype(np.float32))
        before = kernels.launches()["window_update"]
        if f % 2:
            mask = _on(dev, rng.random((t, b)) > 0.3)
            lk = tw.window_update(st_k, ids, vals, mask=mask)
            lp = tw.window_update_plain(st_p, ids, vals, mask=mask)
        else:
            counts = _on(dev, rng.integers(0, b + 1, (t, 1)).astype(np.int32))
            lk = tw.window_update(st_k, ids, vals, counts=counts)
            lp = tw.window_update_plain(st_p, ids, vals, counts=counts)
        assert kernels.launches()["window_update"] == before + 1
        torch.cuda.synchronize()
        assert torch.equal(lk, lp)
        for a, c in zip(st_k, st_p):
            assert torch.equal(a, c)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ks_windows_mode_matches_plain(dev, dtype):
    cfg = make_config("lstm_ad", {"dtype": dtype})
    gen = torch.Generator().manual_seed(0)
    trees = [lstm_ad.init(gen, cfg, device=dev) for _ in range(3)]
    params = {k: {x: torch.stack([p[k][x] for p in trees]) for x in ("w", "b")}
              for k in trees[0]}
    rng = np.random.default_rng(10)
    wins = _on(dev, rng.normal(size=(3, 40, 32)).astype(np.float32))
    nv = _on(dev, rng.integers(0, 33, (3, 40)).astype(np.int32))
    for k in (1, 3):
        before = kernels.launches()["lstm_score"]
        got = lstm_ad.score_stacked(params, cfg, wins, nv, k=k)
        assert kernels.launches()["lstm_score"] == before + 1
        want = lstm_ad.score_stacked_plain(params, cfg, wins, nv, k=k)
        torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("kind", [torch.float32, torch.bfloat16, torch.float16])
def test_kh_and_kg_match_plain(dev, kind):
    rng = np.random.default_rng(11)
    t, b = 5, 3000
    scores = torch.from_numpy(rng.lognormal(-1, 2, (t, b)).astype(np.float32))
    scores[0, :7] = float("nan")
    scores = scores.to(dev).to(kind)
    counts = _on(dev, np.array([[3000], [0], [17], [2999], [5000]], np.int32))
    active = _on(dev, np.array([True, True, False, True, True]))
    edges = torch.from_numpy(
        np.logspace(-3, 2, 63, dtype=np.float32)).to(dev)
    assert torch.equal(score_sketch(scores, active, edges, counts=counts),
                       score_sketch_plain(scores, active, edges, counts=counts))
    for size in (2048, 16384, 4000):
        g = gather_rows(scores, counts, size)
        p = gather_rows_plain(scores, counts, size)
        bits = torch.int16 if kind != torch.float32 else torch.int32
        assert torch.equal(g.view(bits), p.view(bits))


@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_scorer_kernels_match_plain_twin(dev, wire):
    """The card's scorer through KW/KS/KH/KG against a plain twin on the
    card: state and gather layout bitwise, scores within the bf16 bar."""
    spec, cfg = get_model("lstm_ad"), make_config("lstm_ad", {})
    mk = lambda plain: ShardedScorer(  # noqa: E731
        MeshManager(device=dev), spec, cfg, slots_per_shard=4,
        max_streams=1024, window=32, wire_dtype=wire, plain=plain,
    )
    kern, plain = mk(False), mk(True)
    for s in (0, 1, 3):
        kern.activate(s)
        plain.activate(s)
    rng = np.random.default_rng(26)
    kernels.reset_launches()
    for _ in range(4):
        ids = rng.integers(0, 300, (4, 256)).astype(np.uint16)
        vals = rng.normal(size=(4, 256)).astype(np.float32)
        if wire == "bf16":
            vals = f32_to_bf16_bits(vals)
        counts = rng.integers(0, 257, (4, 1)).astype(np.int32)
        sk = kern.step_counts(*kern.stage_inputs(ids, vals, counts))
        sp = plain.step_counts(*plain.stage_inputs(ids, vals, counts))
        np.testing.assert_allclose(sk.numpy_f32(), sp.numpy_f32(), rtol=2e-2, atol=2e-2)
        for a, c in zip(kern.state, plain.state):
            assert torch.equal(a, c)
        n = int(counts.sum())
        gk = kern.gather_rows(sk, counts, n).numpy_f32()
        gp = plain.gather_rows(sp, counts, n).numpy_f32()
        np.testing.assert_array_equal(np.isnan(gk), np.isnan(gp))
        np.testing.assert_allclose(gk[:n], gp[:n], rtol=2e-2, atol=2e-2)
    counts = kernels.launches()
    assert all(counts[k] == 4 for k in ("window_update", "lstm_score", "score_sketch",
                                         "gather_rows"))
    assert counts["gru_score"] == counts["deepar_forecast"] == 0


def _deepar_stack(dev, cfg, n):
    gen = torch.Generator().manual_seed(1)
    trees = [deepar.init(gen, cfg, device=dev) for _ in range(n)]
    for i, p in enumerate(trees):
        p["sigma"]["b"] -= 2.0 * i  # slot 1 and up: small sigma, negative NLLs
        for node in p.values():
            node["b"] += 0.05 * torch.randn(node["b"].shape, generator=gen).to(dev)
    return {k: {x: torch.stack([p[k][x] for p in trees]) for x in ("w", "b")}
            for k in trees[0]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kd_matches_plain_in_both_modes(dev, dtype):
    cfg = make_config("deepar", {"dtype": dtype})
    params = _deepar_stack(dev, cfg, 3)
    rng = np.random.default_rng(12)
    wins = _on(dev, rng.normal(size=(3, 40, 32)).astype(np.float32))
    nv = _on(dev, rng.integers(0, 33, (3, 40)).astype(np.int32))
    for k in (1, 3):
        before = kernels.launches()["gru_score"]
        got = deepar.score_stacked(params, cfg, wins, nv, k=k)
        assert kernels.launches()["gru_score"] == before + 1
        want = deepar.score_stacked_plain(params, cfg, wins, nv, k=k)
        torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)
        assert bool((want < 0).any())
    one = {k: {x: v[0] for x, v in node.items()} for k, node in params.items()}
    torch.testing.assert_close(
        deepar.score(one, cfg, wins[0], nv[0]),
        deepar.score_stacked_plain(params, cfg, wins, nv)[0, :, 0], rtol=2e-2, atol=2e-2,
    )
    # ring mode, the flush form: counts and mask validity, u16 ids, f16 wire
    st = tw.init_window_state(256, 32, device=dev, n_slots=3)
    st.values.copy_(torch.from_numpy(rng.normal(size=(3, 256, 32)).astype(np.float32)))
    st.count.copy_(_on(dev, rng.integers(0, 70, (3, 256)).astype(np.int32)))
    st.pos.copy_(_on(dev, rng.integers(0, 32, (3, 256)).astype(np.int32)))
    ids = _on(dev, rng.integers(0, 300, (3, 100)).astype(np.uint16))
    later = _on(dev, rng.integers(0, 4, (3, 100)).astype(np.int32))
    active = _on(dev, np.array([True, True, False]))
    for k, counts, mask in [
        (1, _on(dev, np.array([[100], [37], [100]], np.int32)), None),
        (3, None, _on(dev, rng.random((3, 100)) > 0.4)),
    ]:
        for out_dtype in (torch.float32, torch.float16):
            got = deepar.gru_score(params, cfg, st, ids, later, active, counts, mask, k, out_dtype)
            want = deepar.gru_score_plain(params, cfg, st, ids, later, active, counts, mask,
                                          k, out_dtype)
            assert got.dtype == want.dtype == out_dtype
            torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
            assert bool((got[2] == 0).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kf_matches_plain_on_the_same_noise(dev, dtype):
    cfg = make_config("deepar", {"dtype": dtype, "context": 48, "horizon": 6,
                                 "num_samples": 16})
    gen = torch.Generator().manual_seed(2)
    params = deepar.init(gen, cfg, device=dev)
    rng = np.random.default_rng(13)
    wins = _on(dev, (20 + 3 * np.sin(np.arange(48)[None] / 5 + np.arange(5)[:, None])
                     + 0.2 * rng.normal(size=(5, 48))).astype(np.float32))
    eps = torch.randn((6, 16 * 5), generator=torch.Generator(dev).manual_seed(3), device=dev)
    before = kernels.launches()["deepar_forecast"]
    samples, mean = deepar.forecast(params, cfg, wins, eps=eps)
    assert kernels.launches()["deepar_forecast"] == before + 1
    ps, pm = deepar.forecast_plain(params, cfg, wins, eps)
    assert samples.shape == ps.shape == (16, 5, 6) and mean.shape == (5, 6)
    torch.testing.assert_close(samples[..., 0], ps[..., 0], rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(mean, pm, rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(mean, samples.mean(0), rtol=1e-5, atol=1e-5)
    if dtype == "float32":
        torch.testing.assert_close(samples, ps, rtol=1e-4, atol=1e-4)
    g1 = torch.Generator(dev).manual_seed(4)
    s1, _ = deepar.forecast(params, cfg, wins, g1)
    assert bool(torch.isfinite(s1).all())


@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_deepar_scorer_kernels_match_plain_twin(dev, wire):
    """A DeepAR scorer on the card (KW, KD, KH, KG) against a plain twin:
    state and gather layout bitwise, scores within the bf16 bar."""
    spec, cfg = get_model("deepar"), make_config("deepar", {})
    mk = lambda plain: ShardedScorer(  # noqa: E731
        MeshManager(device=dev), spec, cfg, slots_per_shard=4,
        max_streams=1024, window=32, wire_dtype=wire, plain=plain,
    )
    kern, plain = mk(False), mk(True)
    own = _deepar_stack(dev, cfg, 2)
    for s in (0, 1, 3):
        tree = {k: {x: v[1 if s == 1 else 0] for x, v in n.items()} for k, n in own.items()}
        kern.activate(s, params=tree)
        plain.activate(s, params=tree)
    rng = np.random.default_rng(27)
    kernels.reset_launches()
    for _ in range(4):
        ids = rng.integers(0, 60, (4, 256)).astype(np.uint16)
        vals = rng.normal(size=(4, 256)).astype(np.float32)
        if wire == "bf16":
            vals = f32_to_bf16_bits(vals)
        counts = rng.integers(0, 257, (4, 1)).astype(np.int32)
        sk = kern.step_counts(*kern.stage_inputs(ids, vals, counts))
        sp = plain.step_counts(*plain.stage_inputs(ids, vals, counts))
        np.testing.assert_allclose(sk.numpy_f32(), sp.numpy_f32(), rtol=2e-2, atol=2e-2)
        # the sketch bins the kernel's own scores, negative NLLs in bin 0
        plane = sk.numpy_f32()
        bins = np.r_[-np.inf, kern.sketch_edges, np.inf]
        want = [np.histogram(plane[t, :counts[t, 0]], bins=bins)[0] if t != 2
                else np.zeros(64, np.int64) for t in range(4)]
        np.testing.assert_array_equal(np.asarray(kern.last_sketch)[:, 0], np.stack(want))
        for a, c in zip(kern.state, plain.state):
            assert torch.equal(a, c)
        n = int(counts.sum())
        gk = kern.gather_rows(sk, counts, n).numpy_f32()
        gp = plain.gather_rows(sp, counts, n).numpy_f32()
        np.testing.assert_array_equal(np.isnan(gk), np.isnan(gp))
        np.testing.assert_allclose(gk[:n], gp[:n], rtol=2e-2, atol=2e-2)
    assert (sk.numpy_f32() < 0).any()
    counts = kernels.launches()
    assert all(counts[k] == 4 for k in ("window_update", "gru_score", "score_sketch",
                                         "gather_rows"))
    assert counts["lstm_score"] == 0


# -- the recurrent kernels at every width and weight format ---------------------

def _recurrent_stack(dev, family, cfg, n=3, seed=41):
    """n slots of a recurrent family's params with their own biases."""
    spec = get_model(family)
    gen = torch.Generator().manual_seed(seed)
    trees = [spec.init(gen, cfg, device=dev) for _ in range(n)]
    for tree in trees:
        for node in tree.values():
            node["b"] += 0.05 * torch.randn(node["b"].shape, generator=gen).to(dev)
    return tc.tree_map(lambda *xs: torch.stack(xs), *trees)


def _ring_case(dev, rng, t=3, s=256, w=32, b=100):
    st = tw.init_window_state(s, w, device=dev, n_slots=t)
    st.values.copy_(torch.from_numpy(rng.normal(size=(t, s, w)).astype(np.float32)))
    st.count.copy_(_on(dev, rng.integers(0, 2 * w, (t, s)).astype(np.int32)))
    st.pos.copy_(_on(dev, rng.integers(0, w, (t, s)).astype(np.int32)))
    ids = _on(dev, rng.integers(0, s + 20, (t, b)).astype(np.uint16))
    later = _on(dev, rng.integers(0, 4, (t, b)).astype(np.int32))
    active = _on(dev, np.array([True, True, False]))
    counts = _on(dev, np.array([[b], [37], [b]], np.int32))
    return st, ids, later, active, counts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("param_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("hidden", [8, 16, 32, 64])
@pytest.mark.parametrize("family", ["lstm_ad", "deepar"])
def test_ks_kd_widths_and_formats_match_plain(dev, family, hidden, param_dtype, dtype):
    """KS and KD at each width on the serving tree in each storage format,
    windows mode (K 1 and 3) and ring mode (the flush form), against the
    plain version on the same quantized tree: 2e-4 in f32 compute, 2e-2 in
    bf16; each launch counted under its variant."""
    spec = get_model(family)
    cfg = make_config(family, {"dtype": dtype, "hidden": hidden})
    q = tc.quantize_params(_recurrent_stack(dev, family, cfg), param_dtype)
    name = "lstm_score" if family == "lstm_ad" else "gru_score"
    tol = 2e-4 if dtype == "float32" else 2e-2
    rng = np.random.default_rng(42)
    wins = _on(dev, rng.normal(size=(3, 40, 32)).astype(np.float32))
    nv = _on(dev, rng.integers(0, 33, (3, 40)).astype(np.int32))
    kernels.reset_launches()
    for k in (1, 3):
        got = spec.score_stacked(q, cfg, wins, nv, k=k)
        want = (lstm_ad if family == "lstm_ad" else deepar).score_stacked_plain(
            q, cfg, wins, nv, k=k)
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    st, ids, later, active, counts = _ring_case(dev, rng)
    got = spec.score_flush(q, cfg, st, ids, later, active, counts, None, 3, torch.float32)
    want = spec.score_flush_plain(q, cfg, st, ids, later, active, counts, None, 3,
                                  torch.float32)
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert bool((got[2] == 0).all()) and bool((got[0] != 0).any())
    assert kernels.variant_launches() == {f"{name}[h{hidden},{param_dtype}]": 3}


@pytest.mark.parametrize("hidden", [8, 16, 32, 64])
@pytest.mark.parametrize("family", ["lstm_ad", "deepar"])
def test_bf16_storage_is_bitwise_f32_masters_at_bf16_compute(dev, family, hidden):
    """bf16 storage is the masters cast once, which is the cast a bf16
    computation reads the masters with: KS and KD give the same bits from
    either tree, in both modes."""
    spec = get_model(family)
    cfg = make_config(family, {"dtype": "bfloat16", "hidden": hidden})
    masters = _recurrent_stack(dev, family, cfg)
    bf = tc.quantize_params(masters, "bf16")
    rng = np.random.default_rng(43)
    wins = _on(dev, rng.normal(size=(3, 40, 32)).astype(np.float32))
    nv = _on(dev, rng.integers(0, 33, (3, 40)).astype(np.int32))
    assert torch.equal(spec.score_stacked(bf, cfg, wins, nv, k=3),
                       spec.score_stacked(masters, cfg, wins, nv, k=3))
    st, ids, later, active, counts = _ring_case(dev, rng)
    args = (cfg, st, ids, later, active, counts, None, 1, torch.bfloat16)
    assert torch.equal(spec.score_flush(bf, *args), spec.score_flush(masters, *args))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden", [8, 16, 32])
def test_kf_widths_match_plain(dev, hidden, dtype):
    cfg = make_config("deepar", {"dtype": dtype, "context": 48, "horizon": 6,
                                 "num_samples": 16, "hidden": hidden})
    params = deepar.init(torch.Generator().manual_seed(2), cfg, device=dev)
    rng = np.random.default_rng(13)
    wins = _on(dev, (20 + 3 * np.sin(np.arange(48)[None] / 5 + np.arange(5)[:, None])
                     + 0.2 * rng.normal(size=(5, 48))).astype(np.float32))
    eps = torch.randn((6, 16 * 5), generator=torch.Generator(dev).manual_seed(3), device=dev)
    kernels.reset_launches()
    samples, mean = deepar.forecast(params, cfg, wins, eps=eps)
    assert kernels.variant_launches() == {f"deepar_forecast[h{hidden}]": 1}
    ps, pm = deepar.forecast_plain(params, cfg, wins, eps)
    torch.testing.assert_close(samples[..., 0], ps[..., 0], rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(mean, pm, rtol=2e-2, atol=2e-2)
    if dtype == "float32":
        torch.testing.assert_close(samples, ps, rtol=1e-4, atol=1e-4)
    with pytest.raises(NotImplementedError, match="master weights"):
        deepar.forecast(tc.quantize_params(params, "int8"), cfg, wins, eps=eps)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_score_legacy_runs_on_the_card(dev, dtype):
    """``lstm_ad.score`` on CUDA tensors (KS in windows mode, one slot)
    against the legacy plain version on the CPU."""
    cfg = make_config("lstm_ad", {"dtype": dtype, "hidden": 16, "window": 16})
    params = lstm_ad.init(torch.Generator().manual_seed(5), cfg, device="cpu")
    for node in params.values():
        node["b"] += 0.05
    rng = np.random.default_rng(46)
    wins = rng.normal(size=(300, 16)).astype(np.float32)
    nv = rng.integers(0, 17, 300).astype(np.int32)
    before = kernels.launches()["lstm_score"]
    got = lstm_ad.score(tc.tree_map(lambda x: x.to(dev), params), cfg,
                        _on(dev, wins), _on(dev, nv))
    assert kernels.launches()["lstm_score"] == before + 1
    want = lstm_ad.score(params, cfg, torch.from_numpy(wins), torch.from_numpy(nv))
    tol = 2e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.cpu(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("hidden", [16, 64])
@pytest.mark.parametrize("param_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("family", ["lstm_ad", "deepar"])
def test_quantized_scorer_kernels_match_plain_twin(dev, family, param_dtype, hidden):
    """A bf16/int8 scorer on the card (KW, KS or KD on the quantized view,
    KH, KG) against its plain twin; a train step and ``commit_swap``
    re-derive the view from the trained masters on both."""
    spec = get_model(family)
    cfg = make_config(family, {"hidden": hidden})
    mk = lambda plain: ShardedScorer(  # noqa: E731
        MeshManager(device=dev), spec, cfg, slots_per_shard=4, max_streams=1024,
        window=32, param_dtype=param_dtype, plain=plain,
    )
    kern, plain = mk(False), mk(True)
    for s in (0, 1, 3):
        for sc in (kern, plain):
            sc.activate(s, lr=1e-3)
    rng = np.random.default_rng(47)
    name = "lstm_score" if family == "lstm_ad" else "gru_score"
    kernels.reset_launches()
    for f in range(6):
        if f == 4:
            for sc in (kern, plain):
                sc.init_optimizer()
                sc.train_lane_step()
                sc.commit_swap()
            for sc in (kern, plain):
                want = tc.quantize_params(sc.params, param_dtype)
                assert all(torch.equal(a, b) for a, b in zip(
                    tc.tree_leaves(sc.kernel_params()), tc.tree_leaves(want)))
        ids = rng.integers(0, 300, (4, 256)).astype(np.uint16)
        vals = rng.normal(size=(4, 256)).astype(np.float32)
        counts = rng.integers(0, 257, (4, 1)).astype(np.int32)
        sk = kern.step_counts(*kern.stage_inputs(ids, vals, counts))
        sp = plain.step_counts(*plain.stage_inputs(ids, vals, counts))
        np.testing.assert_allclose(sk.numpy_f32(), sp.numpy_f32(), rtol=2e-2, atol=2e-2)
    assert kernels.variant_launches()[f"{name}[h{hidden},{param_dtype}]"] == 6


# -- K3'c, the serving half: KW's multi-block form, KS/KD/KF's wide forms ------

@pytest.mark.parametrize("id_dtype", [np.int32, np.uint16])
def test_kw_multi_block_matches_plain_and_one_block(dev, id_dtype):
    """The multi-block KW bitwise the plain version and the one-block KW:
    forced at shapes both forms take (300 and 16,384 rows a slot), and on
    its own route at config 1's 65,536 rows on one slot and at 40,000 rows
    on two slots, chained flushes with bursts past W, counts and mask."""
    rng = np.random.default_rng(5)
    for t, s, w, b, routes in ((4, 512, 8, 300, ("block", "multi")),
                               (2, 4096, 32, 16384, ("block", "multi")),
                               (1, 4096, 32, 65536, ("multi",)),
                               (2, 8192, 16, 40000, ("multi",))):
        states = {r: tw.init_window_state(s, w, device=dev, n_slots=t) for r in routes}
        st_p = tw.init_window_state(s, w, device=dev, n_slots=t)
        for f in range(3):
            ids = rng.integers(0, s, (t, b))
            ids[0, :4 * w] = 7                  # a burst far past the window
            ids[-1, 3] = s + 5                  # out of range: ranked, never written
            ids = _on(dev, ids.astype(id_dtype))
            vals = _on(dev, rng.normal(size=(t, b)).astype(np.float32))
            if f % 2:
                kw = dict(mask=_on(dev, rng.random((t, b)) > 0.3))
            else:
                kw = dict(counts=_on(dev, rng.integers(0, b + 1, (t, 1)).astype(np.int32)))
            lp = tw.window_update_plain(st_p, ids, vals, **kw)
            for r, st in states.items():
                before = kernels.launches()
                lk = tw.window_update(st, ids, vals, route=r, **kw)
                name = "window_update" if r == "block" else "window_update_multi"
                assert kernels.launches()[name] == before[name] + 1
                torch.cuda.synchronize()
                assert torch.equal(lk, lp)
                for a, c in zip(st, st_p):
                    assert torch.equal(a, c)


def test_train_feed_ingest_takes_the_multi_block_kw(dev):
    """The train feed's ingest routes by rows a slot as the flush does: a
    replay microbatch of 20,000 rows a slot goes through KW's multi-block
    form, its feed rings bitwise a plain twin's."""
    spec, cfg = get_model("lstm_ad"), make_config("lstm_ad", {"window": 16, "hidden": 16})
    kern, plain = (ShardedScorer(MeshManager(device=dev), spec, cfg, slots_per_shard=2,
                                 max_streams=1024, window=16, plain=p) for p in (False, True))
    rng = np.random.default_rng(6)
    ids = rng.integers(0, 1100, (2, 20000)).astype(np.uint16)
    vals = rng.normal(size=(2, 20000)).astype(np.float32)
    counts = np.array([[20000], [13000]], np.int32)
    kernels.reset_launches()
    for sc in (kern, plain):
        sc.train_feed_ingest(*sc.stage_inputs(ids, vals, counts))
    torch.cuda.synchronize()
    assert kernels.launches()["window_update_multi"] == 1
    assert kernels.launches()["window_update"] == 0
    for a, c in zip(kern._train_feed_state, plain._train_feed_state):
        assert torch.equal(a, c)


WIDE_HIDDENS = [4, 40, 96, 128, 256]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("param_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("hidden", WIDE_HIDDENS)
@pytest.mark.parametrize("family", ["lstm_ad", "deepar"])
def test_wide_ks_kd_match_plain(dev, family, hidden, param_dtype, dtype):
    """KS and KD's wide form at hidden 4, 40, 96, 128, 256 on the serving
    tree in each storage format: windows mode (K 1 and 3, window 48; K 2
    at window 512) and ring mode at window 192 (the flush form), against
    the plain version on the same tree: 2e-4 in f32 compute, 2e-2 in bf16;
    every launch counted under the wide form's variant."""
    spec = get_model(family)
    cfg = make_config(family, {"dtype": dtype, "hidden": hidden})
    q = tc.quantize_params(_recurrent_stack(dev, family, cfg), param_dtype)
    name = ("lstm_score" if family == "lstm_ad" else "gru_score") + "_wide"
    plain = (lstm_ad if family == "lstm_ad" else deepar).score_stacked_plain
    tol = 2e-4 if dtype == "float32" else 2e-2
    rng = np.random.default_rng(44 + hidden)
    kernels.reset_launches()
    for w, ks in ((48, (1, 3)), (512, (2,))):
        wins = _on(dev, np.cumsum(rng.normal(size=(3, 40, w)), -1).astype(np.float32))
        nv = _on(dev, rng.integers(0, w + 1, (3, 40)).astype(np.int32))
        for k in ks:
            got = spec.score_stacked(q, cfg, wins, nv, k=k)
            torch.testing.assert_close(got, plain(q, cfg, wins, nv, k=k), rtol=tol, atol=tol)
    st, ids, later, active, counts = _ring_case(dev, rng, w=192)
    got = spec.score_flush(q, cfg, st, ids, later, active, counts, None, 3, torch.float32)
    want = spec.score_flush_plain(q, cfg, st, ids, later, active, counts, None, 3,
                                  torch.float32)
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert bool((got[2] == 0).all()) and bool((got[0] != 0).any())
    assert kernels.variant_launches() == {f"{name}[h{hidden},{param_dtype}]": 4}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden, samples", [(40, 100), (40, 256), (64, 256), (128, 20)])
def test_wide_kf_matches_plain(dev, hidden, samples, dtype):
    """KF's wide form (paths split over blocks, the mean a second kernel) at
    GluonTS DeepAR's hidden 40 with its 100 default paths and 256, hidden 64
    at 256 paths, against the plain version on the same noise."""
    cfg = make_config("deepar", {"dtype": dtype, "context": 168, "horizon": 6,
                                 "num_samples": samples, "hidden": hidden})
    params = deepar.init(torch.Generator().manual_seed(2), cfg, device=dev)
    rng = np.random.default_rng(14)
    wins = _on(dev, (20 + 3 * np.sin(np.arange(168)[None] / 5 + np.arange(5)[:, None])
                     + 0.2 * rng.normal(size=(5, 168))).astype(np.float32))
    eps = torch.randn((6, samples * 5), generator=torch.Generator(dev).manual_seed(3),
                      device=dev)
    kernels.reset_launches()
    samples_k, mean = deepar.forecast(params, cfg, wins, eps=eps)
    assert kernels.variant_launches() == {f"deepar_forecast_wide[h{hidden},s{samples}]": 1}
    ps, pm = deepar.forecast_plain(params, cfg, wins, eps)
    torch.testing.assert_close(samples_k[..., 0], ps[..., 0], rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(mean, pm, rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(mean, samples_k.mean(0), rtol=1e-5, atol=1e-5)
    if dtype == "float32":
        torch.testing.assert_close(samples_k, ps, rtol=1e-4, atol=1e-4)


def test_kernel_paths_raise_where_not_built(dev):
    """A scorer at hidden 128 serves on the card through KS's wide form
    (before K3'c's serving half it raised) and, since K3'c's training
    half, trains through KB's wide form; a scorer at hidden 800 serves
    (KS's wide form) and, since K3'c's last part, trains through KB's
    global form, past the widest hidden KB's wide form holds (784; its
    train step raised naming K3'c before); a hidden whose block state no
    longer fits shared memory for serving serves through KS's global form
    (it raised naming K3'c before); the transformer at int8, refused
    before KE and KN read the formats, now runs: KE and KN in their int8
    variant, KQ for the projections; KA past head dim 256 (it raised naming
    K3'c before the split form) runs its split form, held against the
    plain version."""
    mm = MeshManager(device=dev)
    wide = ShardedScorer(mm, get_model("lstm_ad"), make_config("lstm_ad", {"hidden": 128}),
                         slots_per_shard=2, max_streams=64, window=32, param_dtype="int8")
    wide.activate(0, lr=1e-3)
    z = np.zeros((2, 8), np.uint16), np.zeros((2, 8), np.float32), np.ones((2, 1), np.int32)
    kernels.reset_launches()
    assert np.isfinite(wide.step_counts(*z).numpy_f32()).all()
    assert kernels.variant_launches() == {"lstm_score_wide[h128,int8]": 1}
    wide.init_optimizer()
    kernels.reset_launches()
    assert np.isfinite(np.asarray(wide.train_lane_step())).all()
    assert kernels.variant_launches()["lstm_train_wide[h128]"] == 2
    wider = ShardedScorer(mm, get_model("lstm_ad"), make_config("lstm_ad", {"hidden": 800}),
                          slots_per_shard=1, max_streams=8, window=32)
    wider.activate(0)
    wider.init_optimizer()
    kernels.reset_launches()
    assert np.isfinite(np.asarray(wider.train_lane_step())).all()
    assert kernels.variant_launches()["lstm_train_global[h800]"] == 2
    huge = ShardedScorer(mm, get_model("lstm_ad"), make_config("lstm_ad", {"hidden": 2048}),
                         slots_per_shard=1, max_streams=8, window=32)
    huge.activate(0)
    z1 = np.zeros((1, 8), np.uint16), np.zeros((1, 8), np.float32), np.ones((1, 1), np.int32)
    kernels.reset_launches()
    assert np.isfinite(huge.step_counts(*z1).numpy_f32()).all()
    assert kernels.variant_launches() == {"lstm_score_global[h2048,f32]": 1}
    tf = ShardedScorer(mm, get_model("transformer"), make_config("transformer", {"depth": 1}),
                       slots_per_shard=2, max_streams=64, window=32, param_dtype="int8")
    tf.activate(0)
    kernels.reset_launches()
    scores = tf.step_counts(*z).numpy_f32()
    assert np.isfinite(scores).all()
    variants = kernels.variant_launches()
    assert variants["tf_embed[int8]"] == variants["tf_head[int8]"] == 1
    assert kernels.launches()["dequant"] == 6  # wq, wk, wv, wo, fc1, fc2
    q, k, v = (torch.randn((1, 4, 2 * 264), generator=torch.Generator(dev).manual_seed(i),
                           device=dev) for i in range(3))
    kernels.reset_launches()
    out = tc.attention(q, k, v, 2, False)
    assert kernels.launches()["attention_split"] == 1
    torch.testing.assert_close(out, tc.attention_plain(q, k, v, 2, False), rtol=2e-4, atol=2e-4)


# -- the transformer family: KE, KL, KA, KU, KN ----------------------------------

TF_TOL = dict(rtol=2e-2, atol=2e-2)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tf_stack(dev, cfg, n, seed=5):
    gen = torch.Generator().manual_seed(seed)
    trees = [tt.init(gen, cfg, device=dev) for _ in range(n)]
    for tree in trees:  # non-zero biases and LayerNorm affines
        tc.tree_map(lambda x: x.add_(0.05 * torch.randn(x.shape, generator=gen).to(dev))
                    if x.ndim == 1 else x, tree)
    return tc.tree_map(lambda *xs: torch.stack(xs), *trees)


def _tokens_close(xk, xp, n_valid):
    """KE's tokens against the plain version's, rows of a non-constant
    window: a window with one sample (left-padded) normalizes to noise, the
    rounding residue of its mean over sigma = 1e-6, which differs between
    any two summation orders (the reference's as well; ROADMAP queue 3).
    Those rows score 0 (fewer than 4 samples); their tokens stay finite."""
    assert bool(torch.isfinite(xk.float()).all())
    keep = n_valid >= 2
    torch.testing.assert_close(xk[keep].float(), xp[keep].float(), **TF_TOL)


def _counted(name, fn, *args, **kw):
    before = kernels.launches()[name]
    out = fn(*args, **kw)
    assert kernels.launches()[name] == before + 1
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kl_and_ku_match_plain(dev, dtype):
    rng = np.random.default_rng(40)
    for s, rows, d in [(3, 700, 128), (2, 9, 768)]:
        x = _on(dev, (rng.normal(size=(s * rows, d)) * 2 + 0.5).astype(np.float32)).to(DTYPES[dtype])
        scale = _on(dev, (1 + 0.2 * rng.normal(size=(s, d))).astype(np.float32))
        bias = _on(dev, (0.1 * rng.normal(size=(s, d))).astype(np.float32))
        got = _counted("layernorm", tc.layernorm_rows, x, scale, bias, rows)
        want = tc.layernorm_rows_plain(x, scale, bias, rows)
        assert got.dtype == x.dtype
        torch.testing.assert_close(got.float(), want.float(), **TF_TOL)
        g = _counted("bias_gelu", tc.bias_gelu, x, scale, rows)
        torch.testing.assert_close(g.float(), tc.bias_gelu_plain(x, scale, rows).float(), **TF_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ka_matches_plain(dev, dtype):
    rng = np.random.default_rng(41)
    for n, t, heads, hd, causal in [(50, 31, 4, 32, True), (6, 128, 4, 32, True),
                                    (2, 197, 12, 64, False), (3, 40, 2, 64, True)]:
        q, k, v = (_on(dev, (rng.normal(size=(n, t, heads * hd)) * 1.5).astype(np.float32))
                   .to(DTYPES[dtype]) for _ in range(3))
        got = _counted("attention", tc.attention, q, k, v, heads, causal)
        want = tc.attention_plain(q, k, v, heads, causal)
        assert got.dtype == q.dtype and got.shape == q.shape
        torch.testing.assert_close(got.float(), want.float(), **TF_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ke_and_kn_match_plain_in_their_modes(dev, dtype):
    cfg = make_config("transformer", {"dtype": dtype, "context": 64, "horizon": 3})
    params = _tf_stack(dev, cfg, 3)
    rng = np.random.default_rng(42)
    wins = _on(dev, rng.normal(size=(3, 40, 32)).astype(np.float32))
    nv = _on(dev, rng.integers(0, 33, (3, 40)).astype(np.int32))
    for k in (1, 3):
        xk, tk, nk = _counted("tf_embed", tt.tf_embed, params, cfg, k, windows=wins, n_valid=nv)
        xp, tp, np_ = tt.tf_embed_plain(params, cfg, k, windows=wins, n_valid=nv)
        torch.testing.assert_close(xk.float(), xp.float(), **TF_TOL)
        torch.testing.assert_close(tk, tp, rtol=1e-5, atol=1e-5)
        assert torch.equal(nk, np_)
        h = (torch.randn(xp.shape, generator=torch.Generator(dev).manual_seed(k), device=dev)
             * 2).to(xp.dtype)
        got = _counted("tf_head", tt.tf_head, params, cfg, h, tp, np_, k)
        torch.testing.assert_close(got, tt.tf_head_plain(params, cfg, h, tp, np_, k), **TF_TOL)
    # ring mode and KN's flush epilogue: counts and mask validity, u16 ids
    st = tw.init_window_state(256, 32, device=dev, n_slots=3)
    st.values.copy_(torch.from_numpy(rng.normal(size=(3, 256, 32)).astype(np.float32)))
    st.count.copy_(_on(dev, rng.integers(0, 70, (3, 256)).astype(np.int32)))
    st.pos.copy_(_on(dev, rng.integers(0, 32, (3, 256)).astype(np.int32)))
    ids = _on(dev, rng.integers(0, 300, (3, 100)).astype(np.uint16))
    later = _on(dev, rng.integers(0, 4, (3, 100)).astype(np.int32))
    active = _on(dev, np.array([True, True, False]))
    for k, counts, mask in [
        (1, _on(dev, np.array([[100], [37], [100]], np.int32)), None),
        (3, None, _on(dev, rng.random((3, 100)) > 0.4)),
    ]:
        xk, tk, nk = tt.tf_embed(params, cfg, k, state=st, ids=ids)
        xp, tp, np_ = tt.tf_embed_plain(params, cfg, k, state=st, ids=ids)
        assert torch.equal(nk, np_)
        _tokens_close(xk, xp, np_)
        keep = np_ >= 2  # f32 reassociation, amplified where a window has few samples
        torch.testing.assert_close(tk[keep], tp[keep], rtol=1e-4, atol=1e-4)
        for out_dtype in (torch.float32, torch.float16):
            got = tt.tf_head(params, cfg, xp, tp, np_, k, later, active, counts, mask, out_dtype)
            want = tt.tf_head_plain(params, cfg, xp, tp, np_, k, later, active, counts, mask,
                                    out_dtype)
            assert got.dtype == want.dtype == out_dtype
            torch.testing.assert_close(got.float(), want.float(), **TF_TOL)
            assert bool((got[2] == 0).all())
    # context modes and KN's forecast step (one slot)
    one = tc.tree_map(lambda x: x[:1], params)
    for length in (50, 64, 90):
        raw = _on(dev, (5 + np.sin(np.arange(length)[None] / 4 + np.arange(7)[:, None])
                        + 0.1 * rng.normal(size=(7, length))).astype(np.float32))
        xk, ck, mk, sk = _counted("tf_embed", tt.tf_embed_context, one, cfg, raw=raw)
        xp, cp, mp, sp = tt.tf_embed_context_plain(one, cfg, raw=raw)
        torch.testing.assert_close(xk.float(), xp.float(), **TF_TOL)
        for a, b in ((ck, cp), (mk, mp), (sk, sp)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(tt.tf_embed_context(one, cfg, ctx=cp).float(),
                                   tt.tf_embed_context_plain(one, cfg, ctx=cp).float(), **TF_TOL)
        h = xp.clone()
        eps = torch.randn((7,), device=dev)
        outs = []
        for fn in (tt.tf_head_forecast, tt.tf_head_forecast_plain):
            nxt = torch.zeros_like(cp)
            smp = torch.zeros((7, 3), device=dev)
            mns = torch.zeros((7, 3), device=dev)
            fn(one, cfg, h, cp, nxt, eps, mp, sp, smp, mns, 1)
            outs.append((nxt, smp, mns))
        for a, b in zip(*outs):
            torch.testing.assert_close(a, b, **TF_TOL)
        assert torch.equal(outs[0][0][:, :-1], cp[:, 1:])


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _as_accurate(kern, plain, ref):
    """bf16 scores of the kernel path and of the plain version against the
    f32 plain version's: the kernels' mean abs error no more than 1.25x the
    plain version's + 1e-3. Two bf16 computations of the transformer NLL
    differ past the 2e-2 bar on ~1% of rows whatever their reduction
    orders (ROADMAP queue 3), so the bf16 path is held by its accuracy."""
    ek = (kern.float() - ref).abs().mean().item()
    ep = (plain.float() - ref).abs().mean().item()
    assert ek <= 1.25 * ep + 1e-3, (ek, ep)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transformer_kernel_path_matches_plain(dev, dtype):
    """score_stacked, score and forecast through KE, KL, KA, KU, KN
    against the plain composition on the card: per row at the reference's
    f32 bar 2e-4 in f32 compute; in bf16, score_stacked by its accuracy
    against f32 and the forecast's first step within the bf16 bar."""
    cfg = make_config("transformer", {"dtype": dtype, "context": 48, "horizon": 4, "depth": 2})
    params = _tf_stack(dev, cfg, 3)
    rng = np.random.default_rng(43)
    wins = _on(dev, rng.normal(size=(3, 40, 32)).astype(np.float32))
    nv = _on(dev, rng.integers(0, 33, (3, 40)).astype(np.int32))
    f32_tol = dict(rtol=2e-4, atol=2e-4)
    kernels.reset_launches()
    for k in (1, 3):
        got = tt.score_stacked(params, cfg, wins, nv, k=k)
        want = tt.score_stacked_plain(params, cfg, wins, nv, k=k)
        if dtype == "float32":
            torch.testing.assert_close(got, want, **f32_tol)
        else:
            _as_accurate(got, want, tt.score_stacked_plain(params, _f32(cfg), wins, nv, k=k))
    counts = kernels.launches()
    assert counts["tf_embed"] == counts["tf_head"] == 2
    assert counts["layernorm"] == counts["attention"] * 2 == counts["bias_gelu"] * 2 == 8
    one = tc.tree_map(lambda x: x[0], params)
    assert torch.equal(tt.score(one, cfg, wins[0], nv[0]),
                       tt.score_stacked(tc.tree_map(lambda x: x[:1], params), cfg, wins[:1],
                                        nv[:1])[0, :, 0])
    series = _on(dev, (20 + 3 * np.sin(np.arange(60)[None] / 5 + np.arange(5)[:, None])
                       + 0.2 * rng.normal(size=(5, 60))).astype(np.float32))
    eps = torch.randn((4, 5), generator=torch.Generator(dev).manual_seed(3), device=dev)
    kernels.reset_launches()
    samples, means = tt.forecast(one, cfg, series, eps=eps)
    assert kernels.launches()["tf_head"] == 4 and kernels.launches()["tf_embed"] == 4
    ps, pm = tt.forecast_plain(one, cfg, series, eps)
    if dtype == "float32":
        torch.testing.assert_close(samples, ps, **f32_tol)
        torch.testing.assert_close(means, pm, **f32_tol)
    else:
        torch.testing.assert_close(samples[:, 0], ps[:, 0], **TF_TOL)
        torch.testing.assert_close(means[:, 0], pm[:, 0], **TF_TOL)
    # the quantized trees serve through KE's and KN's formats and KQ, held
    # against the plain version on the same tree
    for pd in ("bf16", "int8"):
        q = tc.quantize_params(params, pd)
        kernels.reset_launches()
        got = tt.score_stacked(q, cfg, wins, nv, k=3)
        assert kernels.variant_launches()[f"tf_embed[{pd}]"] == 1
        assert kernels.launches()["dequant"] == (12 if pd == "int8" else 0)
        want = tt.score_stacked_plain(q, cfg, wins, nv, k=3)
        if dtype == "float32":
            torch.testing.assert_close(got, want, **f32_tol)
        else:
            _as_accurate(got, want, tt.score_stacked_plain(q, _f32(cfg), wins, nv, k=3))


@pytest.mark.parametrize("wire, dtype", [("f32", "float32"), ("f32", "bfloat16"),
                                         ("bf16", "bfloat16")])
def test_transformer_scorer_kernels_match_plain_twin(dev, wire, dtype):
    """A transformer scorer on the card (KW, KE, KL, KA, KU, KN, KH, KG)
    against a plain twin: state and gather layout bitwise; scores per row
    within the reference's f32 bar 2e-4 (plus the wire's bar) in f32
    compute, and in bf16 by their accuracy against an f32 plain scorer."""
    spec = get_model("transformer")
    cfg = make_config("transformer", {"depth": 2, "dtype": dtype})
    mk = lambda plain, c=cfg: ShardedScorer(  # noqa: E731
        MeshManager(device=dev), spec, c, slots_per_shard=4,
        max_streams=1024, window=32, wire_dtype=wire, plain=plain,
    )
    kern, plain, ref = mk(False), mk(True), mk(True, _f32(cfg))
    own = _tf_stack(dev, cfg, 2)
    for s in (0, 1, 3):
        tree = tc.tree_map(lambda x: x[1 if s == 1 else 0], own)
        for sc in (kern, plain, ref):
            sc.activate(s, params=tree)
    rng = np.random.default_rng(44)
    tol = 2e-2 if wire == "bf16" else 2e-4
    kernels.reset_launches()
    for _ in range(4):
        ids = rng.integers(0, 60, (4, 256)).astype(np.uint16)
        vals = rng.normal(size=(4, 256)).astype(np.float32)
        if wire == "bf16":
            vals = f32_to_bf16_bits(vals)
        counts = rng.integers(0, 257, (4, 1)).astype(np.int32)
        sk = kern.step_counts(*kern.stage_inputs(ids, vals, counts))
        sp = plain.step_counts(*plain.stage_inputs(ids, vals, counts))
        sr = ref.step_counts(ids, vals, counts)
        if dtype == "float32":
            np.testing.assert_allclose(sk.numpy_f32(), sp.numpy_f32(), rtol=tol, atol=tol)
        else:
            _as_accurate(sk.tensor, sp.tensor, sr.tensor.float())
        for a, c in zip(kern.state, plain.state):
            assert torch.equal(a, c)
        n = int(counts.sum())
        gk = kern.gather_rows(sk, counts, n).numpy_f32()
        gp = plain.gather_rows(sp, counts, n).numpy_f32()
        np.testing.assert_array_equal(np.isnan(gk), np.isnan(gp))
        plane = sk.numpy_f32()
        np.testing.assert_array_equal(
            gk[:n], np.concatenate([plane[t, :counts[t, 0]] for t in range(4)]))
    counts = kernels.launches()
    assert all(counts[k] == 4 for k in ("window_update", "tf_embed", "tf_head", "score_sketch",
                                         "gather_rows"))
    assert counts["layernorm"] == 16 and counts["attention"] == counts["bias_gelu"] == 8
    assert counts["lstm_score"] == counts["gru_score"] == 0


# -- the ViT classifier's kernels: KP, KJ, KV, KT ------------------------------------

def _vit_params(dev, cfg, seed=6):
    """ViT params with every 1-D leaf moved off its init value, so a kernel
    that drops a bias or an affine fails."""
    gen = torch.Generator().manual_seed(seed)
    params = tv.init(gen, cfg, device=dev)
    return tc.tree_map(lambda x: x.add_(0.05 * torch.randn(x.shape, generator=gen).to(dev))
                       if x.ndim == 1 else x, params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kp_matches_plain(dev, dtype):
    """KP bitwise: u8 frames over all 256 values and pre-normalized f32
    frames, patches of 16 and 8."""
    rng = np.random.default_rng(50)
    frames = rng.integers(0, 256, (3, 48, 32, 3)).astype(np.uint8)
    frames[0].reshape(-1)[:256] = np.arange(256)
    x = _on(dev, frames)
    for patch in (16, 8):
        for src in (x, (x.float() / 255.0 - 0.5) / 0.5):
            got = _counted("frame_patches", tv.frame_patches, src, patch, DTYPES[dtype])
            assert got.shape == (3, (48 // patch) * (32 // patch), patch * patch * 3)
            assert torch.equal(got, tv.frame_patches_plain(src, patch, DTYPES[dtype]))


@pytest.mark.parametrize("sub", [1, 2])
def test_kj_matches_plain(dev, sub):
    """KJ at every ladder width: its RGB within 1e-3 of decode_frames, its
    patches within one bf16 ulp (bf16) or 1e-5 (f32) of the plain
    version's; on a 40 x 24 layout whose grid pads past the crop (patch 8)
    and a 48 x 48 one (patch 16)."""
    import chip_smoke

    frames = np.stack(tsim.camera_frames(48, 3))
    for (w, h), patch in (((40, 24), 8), ((48, 48), 16)):
        planes, lay, _ = chip_smoke.encode_frames(frames[:, :h, :w], sub)
        for k in td.COEF_BUCKETS:
            (y, cb, cr), lk = chip_smoke.truncated(planes, lay, k)
            y, cb, cr = _on(dev, y), _on(dev, cb), _on(dev, cr)
            want_rgb = td.decode_frames(y, cb, cr, lk)
            for dtype in (torch.bfloat16, torch.float32):
                before = kernels.launches()["dct_patches"]
                got, rgb = td.decode_rgb(y, cb, cr, lk, patch, dtype)
                assert kernels.launches()["dct_patches"] == before + 1
                want = td.dct_patches_plain(y, cb, cr, lk, patch, dtype)
                torch.testing.assert_close(rgb, want_rgb, rtol=0, atol=1e-3)
                if dtype == torch.bfloat16:
                    assert chip_smoke.bf16_ulps(got, want)[0] <= 1.0
                else:
                    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_matches_plain(dev, dtype):
    cfg = tv.ViTConfig(image_size=48, patch_size=16, dim=128, depth=1, heads=2, num_classes=10)
    params = _vit_params(dev, cfg)
    rng = np.random.default_rng(51)
    prod = _on(dev, (rng.normal(size=(5, 9, 128)) * 3).astype(np.float32)).to(DTYPES[dtype])
    emb = (prod, params["patch"]["b"], params["cls"], params["pos"])
    got = _counted("vit_embed", tv.vit_embed, *emb)
    assert got.shape == (5, 10, 128) and torch.equal(got, tv.vit_embed_plain(*emb))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kt_matches_plain_and_orders_ties(dev, dtype):
    """KT: logits within the bar, the top-k by the tie-tolerant rule; with
    two classes given the same head column and bias (tied logits), the
    lower index comes first, as jax.lax.top_k orders them."""
    import chip_smoke

    cfg = tv.ViTConfig(image_size=48, patch_size=16, dim=768, depth=1, heads=12,
                       num_classes=1000)
    params = _vit_params(dev, cfg)
    head = {k: v.clone() for k, v in params["head"].items()}
    top = 7
    head["w"][:, 900] = head["w"][:, 3]
    head["b"][900] = head["b"][3]
    rng = np.random.default_rng(52)
    x = _on(dev, (rng.normal(size=(6, 10, 768)) * 2).astype(np.float32)).to(DTYPES[dtype])
    # steer frame 0's [CLS] row onto class 3's column: classes 3 and 900 tie on top
    x[0, 0] = (head["w"][:, 3] * 40).to(x.dtype)
    tol = TF_TOL["rtol"] if dtype == "bfloat16" else 2e-4
    for k in (0, 1, top):
        lk, pk, ik = _counted("vit_head", tv.vit_head, x, params["ln_f"], head, k)
        lp, pp, ip = tv.vit_head_plain(x, params["ln_f"], head, k)
        torch.testing.assert_close(lk, lp, rtol=tol, atol=tol)
        if k == 0:
            assert pk is None and ik is None
            continue
        full = tv.softmax_plain(lp)
        rec = chip_smoke.topk_agreement(pk.cpu(), ik.cpu(), pp.cpu(), ip.cpu(), full.cpu(), tol)
        assert rec["ok"], rec
        assert ik.dtype == torch.int32 and bool((pk[:, :-1] >= pk[:, 1:]).all())
        if k == top:
            assert lk[0, 3] == lk[0, 900] and ik[0, :2].tolist() == [3, 900]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vit_kernel_path_matches_plain(dev, dtype):
    """classify and classify_dct through KP/KJ, KV, KL, KA, KU and KT
    against the plain composition on the card: logits per frame at the
    reference's f32 bar 2e-4 in f32 compute; in bf16 as accurate as the
    plain version against an f32 plain forward; the launch counts of one
    forward."""
    import chip_smoke

    cfg = tv.ViTConfig(image_size=48, patch_size=16, dim=128, depth=2, heads=2, num_classes=50,
                       dtype=dtype)
    params = _vit_params(dev, cfg)
    frames = np.stack(tsim.camera_frames(48, 6))
    x = _on(dev, frames)
    planes, lay, _ = chip_smoke.encode_frames(frames, 2)
    planes = [_on(dev, a) for a in planes]
    for kern, plain, first in (
        (lambda c: tv.classify(params, c, x, 5), lambda c: tv.classify_plain(params, c, x, 5),
         "frame_patches"),
        (lambda c: tv.classify_dct(params, c, *planes, lay, 5),
         lambda c: tv.classify_dct_plain(params, c, *planes, lay, 5), "dct_patches"),
    ):
        kernels.reset_launches()
        lk, pk, ik = kern(cfg)
        counts = kernels.launches()
        assert counts[first] == counts["vit_embed"] == counts["vit_head"] == 1
        assert counts["layernorm"] == 4 and counts["attention"] == counts["bias_gelu"] == 2
        lp, pp, ip = plain(cfg)
        if dtype == "float32":
            torch.testing.assert_close(lk, lp, rtol=2e-4, atol=2e-4)
        else:
            ref = plain(_f32(cfg))[0]
            _as_accurate(lk, lp, ref)
    assert torch.equal(tv.apply(params, cfg, (x.float() / 255.0 - 0.5) / 0.5),
                       tv.classify(params, cfg, (x.float() / 255.0 - 0.5) / 0.5, 0)[0])


# -- the train kernels: KB, KR, KO -------------------------------------------------

def _train_grads(spec, params, cfg, state, rows, plain: bool):
    """Per-row loss and the gradient of the masked per-slot mean on the
    rings ``state``: the kernel (ring mode) or the plain version."""
    def obj(p):
        if plain:
            per_row = spec.loss_stacked_plain(p, cfg, tm_train.ring_windows(state))
        else:
            per_row = spec.loss_ring(p, cfg, state)
        obj.per_row = per_row.detach()
        return ((per_row * rows).sum(-1) / torch.clamp_min(rows.sum(-1), 1.0)).sum()

    _, g = tc.value_and_grad(obj, params)
    return obj.per_row, tc.tree_leaves(g)


def _train_case(dev, family, dtype, t=3, s=200, w=32, hidden=64):
    spec = get_model(family)
    cfg = make_config(family, {"window": w, "dtype": dtype, "hidden": hidden})
    gen = torch.Generator().manual_seed(21)
    trees = [spec.init(gen, cfg, device=dev) for _ in range(t)]
    for tree in trees:
        for node in tree.values():
            node["b"] += 0.05 * torch.randn(node["b"].shape, generator=gen).to(dev)
    params = tc.tree_map(lambda *xs: torch.stack(xs), *trees)
    rng = np.random.default_rng(22)
    st = tw.init_window_state(s, w, device=dev, n_slots=t)
    st.values.copy_(_on(dev, np.cumsum(rng.normal(size=(t, s, w)), -1).astype(np.float32)))
    st.count.copy_(_on(dev, rng.integers(0, 2 * w, (t, s)).astype(np.int32)))
    st.pos.copy_(_on(dev, rng.integers(0, w, (t, s)).astype(np.int32)))
    rows = (st.count.clamp(max=w) >= 8).float()
    rows[1] = 0.0  # a masked-out slot: zero gradient, its tiles skipped
    return spec, cfg, params, st, rows


def _rel(got, want) -> float:
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


@pytest.mark.parametrize("hidden", [8, 16, 32, 64])
@pytest.mark.parametrize("family", ["lstm_ad", "deepar"])
def test_kb_kr_gradients_match_plain(dev, family, hidden):
    """KB (LSTM-AD) and KR (DeepAR) in ring and windows mode at each width:
    f32 loss and gradients per element against the plain version under
    autograd; bf16 gradients within 2e-2 relative norm of the f32 plain
    gradient, as the plain bf16 gradient is."""
    name = "lstm_train" if family == "lstm_ad" else "gru_train"
    spec, cfg32, params, st, rows = _train_case(dev, family, "float32", hidden=hidden)
    kernels.reset_launches()
    loss_k, g_k = _train_grads(spec, params, cfg32, st, rows, plain=False)
    assert kernels.launches()[name] == 2  # forward and backward
    assert kernels.variant_launches() == {f"{name}[h{hidden}]": 2}
    loss_p, g_p = _train_grads(spec, params, cfg32, st, rows, plain=True)
    # the rows the step trains on (a window of 2 to 4 samples, left-padded,
    # is nearly constant; its normalization amplifies reduction order)
    live = st.count >= 8
    torch.testing.assert_close(loss_k[live], loss_p[live], rtol=1e-5, atol=1e-6)
    for a, b in zip(g_k, g_p):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
        assert not bool(a[1].any())
    wins = tm_train.ring_windows(st)
    torch.testing.assert_close(spec.loss_stacked(params, cfg32, wins)[live], loss_p[live],
                               rtol=1e-5, atol=1e-6)
    cfg16 = dataclasses.replace(cfg32, dtype="bfloat16")
    _, g_k16 = _train_grads(spec, params, cfg16, st, rows, plain=False)
    _, g_p16 = _train_grads(spec, params, cfg16, st, rows, plain=True)
    for a, b, want in zip(g_k16, g_p16, g_p):
        assert _rel(a, want) <= 2e-2 and _rel(b, want) <= 2e-2
    # two runs give the same bits (no float atomics)
    _, again = _train_grads(spec, params, cfg16, st, rows, plain=False)
    for a, b in zip(g_k16, again):
        assert torch.equal(a, b)


# the wide train forms' shapes: main path m's (LSTM-AD hidden 128 / window
# 256, DeepAR hidden 40 / window 192), odd widths (12, 100: not a multiple
# of 8 or 32), and a window past the templated form's 128 at hidden 64,
# which its tiles still hold (the templated form keeps it)
WIDE_TRAIN = [("lstm_ad", 128, 256), ("lstm_ad", 12, 140), ("lstm_ad", 100, 33),
              ("lstm_ad", 64, 256), ("deepar", 40, 192), ("deepar", 12, 140),
              ("deepar", 100, 60), ("deepar", 64, 256)]


@pytest.mark.parametrize("family, hidden, w", WIDE_TRAIN)
def test_wide_kb_kr_match_plain(dev, family, hidden, w):
    """KB and KR at shapes past the templated forms' hidden widths or
    windows, through the route (``flush.train_route``): f32 loss and
    gradients per element against the plain version (ring mode; windows
    mode bitwise ring mode on the same windows); bf16 gradients each
    within max(2e-2, 1.25x the plain bf16 version's) relative norm of the
    f32 plain gradient; two runs bitwise; the masked slot's gradient 0."""
    name = {"lstm_ad": "lstm_train", "deepar": "gru_train"}[family]
    form = lstm_ad.KB if family == "lstm_ad" else deepar.KR
    route, _ = tm_train.train_route(form, hidden, w)
    kname = name if route == "block" else f"{name}_wide"
    spec, cfg32, params, st, rows = _train_case(dev, family, "float32", s=100, w=w,
                                                hidden=hidden)
    kernels.reset_launches()
    loss_k, g_k = _train_grads(spec, params, cfg32, st, rows, plain=False)
    assert kernels.variant_launches() == {f"{kname}[h{hidden}]": 2}
    loss_p, g_p = _train_grads(spec, params, cfg32, st, rows, plain=True)
    live = st.count >= 8
    torch.testing.assert_close(loss_k[live], loss_p[live], rtol=1e-5, atol=1e-6)
    for a, b in zip(g_k, g_p):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
        assert not bool(a[1].any())
    wins = tm_train.ring_windows(st)
    _, g_w = tc.value_and_grad(
        lambda p: ((spec.loss_stacked(p, cfg32, wins) * rows).sum(-1)
                   / torch.clamp_min(rows.sum(-1), 1.0)).sum(), params)
    assert all(torch.equal(a, b) for a, b in zip(g_k, tc.tree_leaves(g_w)))
    cfg16 = dataclasses.replace(cfg32, dtype="bfloat16")
    _, g_k16 = _train_grads(spec, params, cfg16, st, rows, plain=False)
    _, g_p16 = _train_grads(spec, params, cfg16, st, rows, plain=True)
    for a, b, want in zip(g_k16, g_p16, g_p):
        assert _rel(a, want) <= max(2e-2, 1.25 * _rel(b, want))
    _, again = _train_grads(spec, params, cfg16, st, rows, plain=False)
    for a, b in zip(g_k16, again):
        assert torch.equal(a, b)


def test_train_kernels_raise_where_not_built(dev):
    """The train forms read the f32 masters only (int8 and bf16 trees
    raise); since K3'c's training half hidden 128 trains through KB's wide
    form, and since K3'c's last part a hidden past the widest the wide form
    holds at 8 rows a block (784 for the LSTM; it raised naming K3'c
    before) trains through KB's global form."""
    spec, cfg, params, st, _ = _train_case(dev, "lstm_ad", "float32")
    q = tc.quantize_params(params, "int8")
    with pytest.raises(NotImplementedError):
        spec.loss_ring(q, cfg, st)
    bf = tc.tree_map(lambda x: x.to(torch.bfloat16), params)
    with pytest.raises(NotImplementedError):
        spec.loss_ring(bf, cfg, st)
    ring = tw.init_window_state(8, 32, device=dev, n_slots=1)

    def one_slot(cfg):
        return tc.tree_map(lambda x: x[None],
                           spec.init(torch.Generator().manual_seed(0), cfg, device=dev))

    wide = make_config("lstm_ad", {"hidden": 128, "window": 32})
    kernels.reset_launches()
    loss = spec.loss_ring(one_slot(wide), wide, ring)
    assert bool(torch.isfinite(loss).all())
    assert kernels.variant_launches() == {"lstm_train_wide[h128]": 1}
    past = make_config("lstm_ad", {"hidden": 785, "window": 32})
    kernels.reset_launches()
    loss = spec.loss_ring(one_slot(past), past, ring)
    assert bool(torch.isfinite(loss).all())
    assert kernels.variant_launches() == {"lstm_train_global[h785]": 1}


# K3'c's last part: the global forms (the wide kernels with the block state
# in global memory) at the first hidden past each wide form's cap, and KS
# at an odd width past it
GLOBAL_SCAN = [("lstm_ad", 1758), ("lstm_ad", 2049), ("deepar", 2232)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("param_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("family, hidden", GLOBAL_SCAN)
def test_global_ks_kd_match_plain(dev, family, hidden, param_dtype, dtype):
    """KS and KD's global form past the wide form's caps (1,757 and 2,231)
    on the serving tree in each storage format: windows mode (K 1 and 3,
    window 12) and ring mode (the flush form, window 16) against the plain
    version on the same tree: 2e-4 in f32 compute, 2e-2 in bf16; every
    launch counted under the global form's variant."""
    spec = get_model(family)
    cfg = make_config(family, {"dtype": dtype, "hidden": hidden})
    q = tc.quantize_params(_recurrent_stack(dev, family, cfg), param_dtype)
    name = ("lstm_score" if family == "lstm_ad" else "gru_score") + "_global"
    plain = (lstm_ad if family == "lstm_ad" else deepar).score_stacked_plain
    tol = 2e-4 if dtype == "float32" else 2e-2
    rng = np.random.default_rng(45 + hidden)
    kernels.reset_launches()
    wins = _on(dev, np.cumsum(rng.normal(size=(3, 20, 12)), -1).astype(np.float32))
    nv = _on(dev, rng.integers(0, 13, (3, 20)).astype(np.int32))
    for k in (1, 3):
        got = spec.score_stacked(q, cfg, wins, nv, k=k)
        torch.testing.assert_close(got, plain(q, cfg, wins, nv, k=k), rtol=tol, atol=tol)
    st, ids, later, active, counts = _ring_case(dev, rng, s=64, w=16, b=40)
    got = spec.score_flush(q, cfg, st, ids, later, active, counts, None, 3, torch.float32)
    want = spec.score_flush_plain(q, cfg, st, ids, later, active, counts, None, 3,
                                  torch.float32)
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert bool((got[2] == 0).all()) and bool((got[0] != 0).any())
    assert kernels.variant_launches() == {f"{name}[h{hidden},{param_dtype}]": 3}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_kf_matches_plain(dev, dtype):
    """KF's global form at hidden 2,234 (past the wide form's 2,233), 40
    paths over 3 series, context 24, horizon 4, against the plain version
    on the same noise."""
    cfg = make_config("deepar", {"dtype": dtype, "context": 24, "horizon": 4,
                                 "num_samples": 40, "hidden": 2234})
    params = deepar.init(torch.Generator().manual_seed(2), cfg, device=dev)
    rng = np.random.default_rng(15)
    wins = _on(dev, (20 + 3 * np.sin(np.arange(24)[None] / 5 + np.arange(3)[:, None])
                     + 0.2 * rng.normal(size=(3, 24))).astype(np.float32))
    eps = torch.randn((4, 40 * 3), generator=torch.Generator(dev).manual_seed(3), device=dev)
    kernels.reset_launches()
    samples_k, mean = deepar.forecast(params, cfg, wins, eps=eps)
    assert kernels.variant_launches() == {"deepar_forecast_global[h2234,s40]": 1}
    ps, pm = deepar.forecast_plain(params, cfg, wins, eps)
    torch.testing.assert_close(samples_k[..., 0], ps[..., 0], rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(mean, pm, rtol=2e-2, atol=2e-2)
    if dtype == "float32":
        torch.testing.assert_close(samples_k, ps, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("family, hidden", [("lstm_ad", 785), ("deepar", 1018)])
def test_global_kb_kr_match_plain(dev, family, hidden):
    """KB and KR's global form at the first hidden past the wide train
    forms' caps (784, 1,017): f32 loss and gradients per element against
    the plain version (ring mode; windows mode bitwise ring mode on the
    same windows); bf16 gradients each within max(2e-2, 1.25x the plain
    bf16 version's) relative norm of the f32 plain gradient; two runs
    bitwise; the masked slot's gradient 0."""
    name = {"lstm_ad": "lstm_train", "deepar": "gru_train"}[family] + "_global"
    spec, cfg32, params, st, rows = _train_case(dev, family, "float32", s=24, w=12,
                                                hidden=hidden)
    kernels.reset_launches()
    loss_k, g_k = _train_grads(spec, params, cfg32, st, rows, plain=False)
    assert kernels.variant_launches() == {f"{name}[h{hidden}]": 2}
    loss_p, g_p = _train_grads(spec, params, cfg32, st, rows, plain=True)
    live = st.count >= 8
    torch.testing.assert_close(loss_k[live], loss_p[live], rtol=1e-5, atol=1e-6)
    for a, b in zip(g_k, g_p):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
        assert not bool(a[1].any())
    wins = tm_train.ring_windows(st)
    _, g_w = tc.value_and_grad(
        lambda p: ((spec.loss_stacked(p, cfg32, wins) * rows).sum(-1)
                   / torch.clamp_min(rows.sum(-1), 1.0)).sum(), params)
    assert all(torch.equal(a, b) for a, b in zip(g_k, tc.tree_leaves(g_w)))
    cfg16 = dataclasses.replace(cfg32, dtype="bfloat16")
    _, g_k16 = _train_grads(spec, params, cfg16, st, rows, plain=False)
    _, g_p16 = _train_grads(spec, params, cfg16, st, rows, plain=True)
    for a, b, want in zip(g_k16, g_p16, g_p):
        assert _rel(a, want) <= max(2e-2, 1.25 * _rel(b, want))
    _, again = _train_grads(spec, params, cfg16, st, rows, plain=False)
    for a, b in zip(g_k16, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("family, hidden", [("lstm_ad", 128), ("deepar", 40)])
def test_global_form_bitwise_the_wide_form(dev, family, hidden):
    """The global form forced (``flush.forced_route``) at the wide form's
    shapes (main path m's widths) against the wide form, which keeps
    them: KS/KD in windows and ring mode in every storage format and both
    compute dtypes, KF (DeepAR), KB/KR's loss and gradients, each bitwise
    the wide form at the same rows a block; the scan and forecast forms
    bitwise at 8 rows a block against 32 too, and the train forms' per-row
    loss (their leaf sums follow the tiles' sum order, so R 8 against 32 is
    held per element at rtol 1e-5)."""
    from sitewhere_tpu_torch.models import flush as tm_flush

    spec = get_model(family)
    rng = np.random.default_rng(46 + hidden)
    wins = _on(dev, np.cumsum(rng.normal(size=(3, 40, 24)), -1).astype(np.float32))
    nv = _on(dev, rng.integers(0, 25, (3, 40)).astype(np.int32))
    st, ids, later, active, counts = _ring_case(dev, rng, s=64, w=24, b=40)
    for dtype in ("float32", "bfloat16"):
        cfg = make_config(family, {"dtype": dtype, "hidden": hidden})
        masters = _recurrent_stack(dev, family, cfg)
        for fmt in ("f32", "bf16", "int8"):
            q = tc.quantize_params(masters, fmt)

            def both():
                return (spec.score_stacked(q, cfg, wins, nv, k=2),
                        spec.score_flush(q, cfg, st, ids, later, active, counts, None, 2,
                                         torch.float32))

            natural = both()
            for rows in (8, 32):
                with tm_flush.forced_route("wide", rows):
                    wide = both()
                kernels.reset_launches()
                with tm_flush.forced_route("global", rows):
                    glob = both()
                assert all(v.startswith(("lstm_score_global", "gru_score_global"))
                           for v in kernels.variant_launches())
                assert all(torch.equal(a, b) for a, b in zip(wide, glob))
                assert all(torch.equal(a, b) for a, b in zip(natural, glob))
    if family == "deepar":
        cfg = make_config("deepar", {"context": 32, "horizon": 4, "num_samples": 50,
                                     "hidden": hidden})
        params = deepar.init(torch.Generator().manual_seed(4), cfg, device=dev)
        eps = torch.randn((4, 50 * 3), generator=torch.Generator(dev).manual_seed(5), device=dev)
        fwins = wins[0, :3, :].repeat(1, 2).contiguous()[:, :32]
        natural = deepar.forecast(params, cfg, fwins, eps=eps)
        for rows in (8, 32):
            with tm_flush.forced_route("global", rows):
                glob = deepar.forecast(params, cfg, fwins, eps=eps)
            assert all(torch.equal(a, b) for a, b in zip(natural, glob))
    spec_t, cfg_t, params, st_t, rows_t = _train_case(dev, family, "bfloat16", s=72, w=24,
                                                      hidden=hidden)
    _, w_rows = tm_train.train_route(lstm_ad.KB if family == "lstm_ad" else deepar.KR,
                                     hidden, 24)
    loss_w, g_w = _train_grads(spec_t, params, cfg_t, st_t, rows_t, plain=False)
    with tm_flush.forced_route("global", w_rows):
        loss_g, g_g = _train_grads(spec_t, params, cfg_t, st_t, rows_t, plain=False)
    assert torch.equal(loss_w, loss_g) and all(torch.equal(a, b) for a, b in zip(g_w, g_g))
    with tm_flush.forced_route("global", 8 if w_rows == 32 else 32):
        loss_r, g_r = _train_grads(spec_t, params, cfg_t, st_t, rows_t, plain=False)
    assert torch.equal(loss_w, loss_r)
    for a, b in zip(g_w, g_r):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_ko_matches_plain(dev):
    """KO against adam_update_plain over 5 steps with mixed masks and
    per-slot lr: every element within one f32 ulp (both compute the
    reference's FMAs; the plain version emulates them in float64)."""
    rng = np.random.default_rng(23)
    t = 5
    cfg = make_config("deepar", {})
    gen = torch.Generator().manual_seed(24)
    params = tc.tree_map(lambda *xs: torch.stack(xs),
                         *[get_model("deepar").init(gen, cfg, device=dev) for _ in range(t)])
    twin = tc.tree_map(torch.clone, params)
    sk, sp = adam.init_adam(params, t), adam.init_adam(twin, t)
    lr = _on(dev, np.array([1e-3, 1e-2, 3e-4, 1.0, 1e-3], np.float32))
    for i in range(5):
        grads = tc.tree_map(lambda x: _on(dev, (rng.normal(size=x.shape) * 10.0 ** rng.uniform(
            -5, 1, size=x.shape)).astype(np.float32)), params)
        mask = _on(dev, np.array([True, i % 2 == 0, True, True, False]))
        before = kernels.launches()["adam_update"]
        adam.adam_update(params, grads, sk, lr, mask)
        assert kernels.launches()["adam_update"] == before + 1
        adam.adam_update_plain(twin, grads, sp, lr, mask)
        torch.cuda.synchronize()
        for a, b in zip(tc.tree_leaves((params, sk.mu, sk.nu)), tc.tree_leaves((twin, sp.mu, sp.nu))):
            ulps = (a.view(torch.int32).long() - b.view(torch.int32).long()).abs().max()
            assert int(ulps) <= 1
        assert torch.equal(sk.count, sp.count)
    assert sk.count.tolist() == [5, 3, 5, 5, 0]


# -- the transformer's train kernels: KA, KL, KU, KE backward, KN's train mode ---
#
# f32 compute: per element at the train bars (rtol 1e-4, atol 1e-5 times the
# output's largest magnitude: the per-slot gradients sum thousands of O(1)
# terms in another order, so an element that cancels to near 0 keeps the
# terms' rounding); bf16: the kernels round where their plain versions round
# and differ only in f32 summation order inside a rounding, so each output
# is held within 1e-2 relative norm of the plain version's (one bf16 ulp is
# 0.4-0.8%), and the per-slot f32 sums likewise.

def _held_train(got, want, dtype):
    assert got.dtype == want.dtype and got.shape == want.shape
    if dtype == "float32":
        scale = max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * scale)
    else:
        assert _rel(got.float(), want.float()) <= 1e-2, _rel(got.float(), want.float())


def _rand(dev, rng, shape, dtype, scale=1.0, shift=0.0):
    return _on(dev, (rng.normal(size=shape) * scale + shift).astype(np.float32)).to(DTYPES[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ka_bwd_matches_plain(dev, dtype):
    rng = np.random.default_rng(70)
    for n, t, heads, hd, causal in [(50, 31, 4, 32, True), (3, 40, 2, 64, True),
                                    (2, 197, 12, 64, False)]:
        q, k, v, do = (_rand(dev, rng, (n, t, heads * hd), dtype, 1.5) for _ in range(4))
        got = _counted("attention_bwd", tc.attention_bwd, q, k, v, do, heads, causal)
        want = tc.attention_bwd_plain(q, k, v, do, heads, causal)
        for a, b in zip(got, want):
            _held_train(a, b, dtype)
        again = tc.attention_bwd(q, k, v, do, heads, causal)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kl_and_ku_bwd_match_plain(dev, dtype):
    rng = np.random.default_rng(71)
    for s, rows, d in [(3, 700, 128), (2, 9, 768)]:
        x = _rand(dev, rng, (s * rows, d), dtype, 2.0, 0.5)
        dy = _rand(dev, rng, (s * rows, d), dtype)
        scale = _on(dev, (1 + 0.2 * rng.normal(size=(s, d))).astype(np.float32))
        got = _counted("layernorm_bwd", tc.layernorm_bwd, x, scale, dy, rows)
        want = tc.layernorm_bwd_plain(x, scale, dy, rows)
        _held_train(got[0], want[0], dtype)
        for a, b in zip(got[1:], want[1:]):  # per-slot f32 sums
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        f = _rand(dev, rng, (s * rows, 4 * d), dtype)
        df = _rand(dev, rng, (s * rows, 4 * d), dtype)
        b = _on(dev, (0.1 * rng.normal(size=(s, 4 * d))).astype(np.float32))
        got = _counted("bias_gelu_bwd", tc.bias_gelu_bwd, f, b, df, rows)
        want = tc.bias_gelu_bwd_plain(f, b, df, rows)
        _held_train(got[0], want[0], dtype)
        _held_train(got[1], want[1], dtype)
        again = tc.bias_gelu_bwd(f, b, df, rows)
        assert torch.equal(got[1], again[1]) and torch.equal(got[0], again[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ke_and_kn_train_modes_match_plain(dev, dtype):
    cfg = make_config("transformer", {"dtype": dtype, "context": 64})
    params = _tf_stack(dev, cfg, 3)
    rng = np.random.default_rng(72)
    st = tw.init_window_state(300, 32, device=dev, n_slots=3)
    st.values.copy_(_on(dev, np.cumsum(rng.normal(size=(3, 300, 32)), -1).astype(np.float32)))
    st.count.copy_(_on(dev, rng.integers(2, 64, (3, 300)).astype(np.int32)))
    st.pos.copy_(_on(dev, rng.integers(0, 32, (3, 300)).astype(np.int32)))
    xk, nk = _counted("tf_embed", tt.tf_embed_train, params, cfg, state=st)
    xp, npl = tt.tf_embed_train_plain(params, cfg, state=st)
    # the rows the train step keeps (>= 8 samples; a window of 2 to 5
    # samples, left-padded, amplifies the reduction order: ROADMAP queue 3)
    live = st.count >= 8
    torch.testing.assert_close(nk[live], npl[live], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(xk[live].float(), xp[live].float(), **TF_TOL)
    wins = tm_train.ring_windows(st)
    xw, nw = tt.tf_embed_train(params, cfg, windows=wins)
    assert torch.equal(xw, xk) and torch.equal(nw, nk)
    dx = _rand(dev, rng, tuple(xk.shape), dtype)
    got = _counted("tf_embed_bwd", tt.tf_embed_bwd, dx, nk, cfg.context)
    want = tt.tf_embed_bwd_plain(dx, nk, cfg.context)
    for a, b in zip(got, want):
        _held_train(a, b, dtype)
    assert not bool(got[2][:, 31:].any())
    h = _rand(dev, rng, tuple(xk.shape), dtype, 2.0).contiguous()
    per_row, out = _counted("tf_head_train", tt.tf_head_train, params, cfg, h, nk)
    per_row_p, out_p = tt.tf_head_train_plain(params, cfg, h, nk)
    torch.testing.assert_close(out, out_p, **TF_TOL)
    torch.testing.assert_close(per_row, per_row_p, **(TF_TOL if dtype == "bfloat16" else
                                                      dict(rtol=1e-5, atol=1e-5)))
    g_row = _on(dev, (rng.random((3, 300)) / 300).astype(np.float32))
    got = _counted("tf_head_train", tt.tf_head_train_bwd, params, cfg, h, nk, out_p, g_row)
    want = tt.tf_head_train_bwd_plain(params, cfg, h, nk, out_p, g_row)
    _held_train(got[0], want[0], dtype)
    for a, b in zip(got[1:], want[1:]):
        _held_train(a.contiguous(), b, dtype)
    assert kernels.variant_launches()["tf_head_train[bwd]"] >= 1


def _leaf_names(tree, prefix=""):
    """``tree_leaves``' order, each leaf named by its path ("blocks/0/attn/wk/b")."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in _leaf_names(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in _leaf_names(v, f"{prefix}{i}/")]
    return [prefix[:-1]]


def _tf_train_case(dev, dtype, t=3, s=64, w=32):
    cfg = make_config("transformer", {"dtype": dtype, "depth": 2})
    params = _tf_stack(dev, cfg, t, seed=25)
    rng = np.random.default_rng(26)
    st = tw.init_window_state(s, w, device=dev, n_slots=t)
    st.values.copy_(_on(dev, np.cumsum(rng.normal(size=(t, s, w)), -1).astype(np.float32)))
    st.count.copy_(_on(dev, rng.integers(8, 2 * w, (t, s)).astype(np.int32)))
    st.pos.copy_(_on(dev, rng.integers(0, w, (t, s)).astype(np.int32)))
    rows = (st.count.clamp(max=w) >= 8).float()
    rows[1] = 0.0
    return get_model("transformer"), cfg, params, st, rows


def test_transformer_train_form_matches_plain(dev):
    """The transformer's train form on the card (ring mode): f32 loss and
    gradients per element against the plain version's; bf16 gradients each
    within 2e-2 relative norm of the f32 plain gradient, or within 1.25x
    the plain bf16 gradient's own error where that is larger (at dim 128
    the first block's LayerNorm scale is ~2% off in both: the bf16 error of
    every later layer's backward lands there); two runs bitwise; one launch
    of each kernel a pass."""
    spec, cfg32, params, st, rows = _tf_train_case(dev, "float32")
    kernels.reset_launches()
    loss_k, g_k = _train_grads(spec, params, cfg32, st, rows, plain=False)
    counts = kernels.launches()
    assert counts["tf_embed"] == 1 and counts["tf_embed_bwd"] == 1
    assert counts["tf_head_train"] == 2 and counts["attention_bwd"] == cfg32.depth
    assert counts["layernorm_bwd"] == 2 * cfg32.depth + 1
    assert counts["bias_gelu_bwd"] == cfg32.depth
    loss_p, g_p = _train_grads(spec, params, cfg32, st, rows, plain=True)
    torch.testing.assert_close(loss_k, loss_p, rtol=1e-5, atol=1e-5)
    for a, b in zip(g_k, g_p):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
        assert not bool(a[1].any())
    cfg16 = dataclasses.replace(cfg32, dtype="bfloat16")
    _, g_k16 = _train_grads(spec, params, cfg16, st, rows, plain=False)
    _, g_p16 = _train_grads(spec, params, cfg16, st, rows, plain=True)
    names = _leaf_names(params)
    ref = dict(zip(names, g_p))
    for name, a, b, want in zip(names, g_k16, g_p16, g_p):
        # attn.wk.b's exact gradient is 0 (softmax ignores a per-query
        # shift): its bar is the same block's attn.wq.b gradient's norm
        scale = ref[name.replace("wk/b", "wq/b")].norm() if name.endswith("wk/b") else want.norm()
        err_k, err_p = (float((g - want).norm() / scale) for g in (a, b))
        assert err_k <= max(2e-2, 1.25 * err_p), (name, err_k, err_p)
    _, again = _train_grads(spec, params, cfg16, st, rows, plain=False)
    assert all(torch.equal(a, b) for a, b in zip(g_k16, again))


def test_ko_takes_the_transformers_tree(dev):
    """KO over the transformer's 71 leaves (several launches of 16 leaves
    from one C call) against its plain version, within one f32 ulp."""
    cfg = make_config("transformer", {})
    params = _tf_stack(dev, cfg, 3)
    twin = tc.tree_map(torch.clone, params)
    sk, sp = adam.init_adam(params, 3), adam.init_adam(twin, 3)
    rng = np.random.default_rng(27)
    lr = _on(dev, np.array([1e-3, 1e-2, 3e-4], np.float32))
    mask = _on(dev, np.array([True, False, True]))
    assert len(tc.tree_leaves(params)) == 71
    for _ in range(2):
        grads = tc.tree_map(lambda x: _on(dev, rng.normal(size=x.shape).astype(np.float32)),
                            params)
        adam.adam_update(params, grads, sk, lr, mask)
        adam.adam_update_plain(twin, grads, sp, lr, mask)
    torch.cuda.synchronize()
    for a, b in zip(tc.tree_leaves((params, sk.mu, sk.nu)), tc.tree_leaves((twin, sp.mu, sp.nu))):
        assert int((a.view(torch.int32).long() - b.view(torch.int32).long()).abs().max()) <= 1
    assert sk.count.tolist() == [2, 0, 2]


def test_transformer_scorer_trains_on_the_card(dev):
    """A transformer scorer's train lane on the card (resident and replay
    steps) against its plain twin at f32 compute: losses, params and Adam
    state at the train bars; then a flush from the trained masters."""
    cfg = make_config("transformer", {"depth": 2, "dtype": "float32"})
    mm = MeshManager(device=dev)
    base = tt.init(torch.Generator().manual_seed(28), cfg, device=dev)
    sc = {plain: ShardedScorer(mm, get_model("transformer"), cfg, slots_per_shard=3,
                               max_streams=64, window=32, base_params=base, plain=plain)
          for plain in (False, True)}
    rng = np.random.default_rng(29)
    ids = np.tile(np.arange(64, dtype=np.uint16), (3, 1))
    for x in sc.values():  # small lrs: an Adam step moves a param ~lr sign(g)
        x.activate(0, lr=1e-4)
        x.activate(1, lr=3e-4)
        x.activate(2, trainable=False)
        x.init_optimizer()
    for i in range(12):
        vals = rng.normal(size=(3, 64)).astype(np.float32)
        counts = np.full((3, 1), 64, np.int32)
        for x in sc.values():
            x.step_counts(*x.stage_inputs(ids, vals, counts))
    for x in sc.values():
        x.train_feed_ingest(*x.stage_inputs(ids, rng.normal(size=(3, 64)).astype(np.float32),
                                            np.full((3, 1), 64, np.int32)))
    for replay in (False, False, True):
        lk = sc[False].train_lane_step(replay=replay)
        lp = sc[True].train_lane_step(replay=replay)
        np.testing.assert_allclose(np.asarray(lk), np.asarray(lp), rtol=1e-5, atol=1e-6)
    for name, a, b in zip(_leaf_names(base) * 3,
                          tc.tree_leaves((sc[False].params, sc[False]._opt_state.mu,
                                          sc[False]._opt_state.nu)),
                          tc.tree_leaves((sc[True].params, sc[True]._opt_state.mu,
                                          sc[True]._opt_state.nu))):
        if name.endswith("wk/b"):
            # its exact gradient is 0: each Adam step moves it by up to lr on
            # the sign of rounding noise (3 steps at lr <= 3e-4)
            assert float((a - b).abs().max()) <= 2 * 3 * 3e-4
        else:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    vals = rng.normal(size=(3, 64)).astype(np.float32)
    counts = np.full((3, 1), 64, np.int32)
    sk = sc[False].step_counts(*sc[False].stage_inputs(ids, vals, counts))
    sp = sc[True].step_counts(*sc[True].stage_inputs(ids, vals, counts))
    np.testing.assert_allclose(sk.numpy_f32(), sp.numpy_f32(), rtol=2e-4, atol=2e-4)


# -- the ViT's train form: KT's train mode, KV's backward, the train step ---------

def _vit_train_case(dev, dtype, b=5):
    cfg = tv.ViTConfig(image_size=48, patch_size=16, dim=128, depth=2, heads=2,
                       num_classes=1000, dtype=dtype)
    params = _vit_params(dev, cfg)
    rng = np.random.default_rng(53)
    images = _on(dev, rng.normal(size=(b, 48, 48, 3)).astype(np.float32))
    labels = _on(dev, np.array([3, -1, 999, 1000, 7][:b], np.int32))
    return cfg, params, images, labels


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kt_train_mode_matches_plain(dev, dtype):
    """KT's train mode at ViT-B/16's widths (dim 768, 1,000 classes; labels
    in range, wrapped and past the classes): the loss and logits, then dh
    (zero but at the [CLS] rows), the head's and ln_f's gradients within
    the bars (f32 per element at the gradient bar, bf16 by relative norm
    1e-2); two runs bitwise; one launch each."""
    cfg = tv.ViTConfig(image_size=48, patch_size=16, dim=768, depth=1, heads=12,
                       num_classes=1000)
    params = _vit_params(dev, cfg)
    rng = np.random.default_rng(54)
    x = _on(dev, (rng.normal(size=(6, 10, 768)) * 2).astype(np.float32)).to(DTYPES[dtype])
    labels = _on(dev, np.array([3, 17, -1, 999, 500, 0], np.int32))
    args = (x, params["ln_f"], params["head"], labels)
    before = kernels.variant_launches().get("vit_head_train[fwd]", 0)
    loss, logits = _counted("vit_head_train", tv.vit_head_train, *args)
    assert kernels.variant_launches()["vit_head_train[fwd]"] == before + 1
    lp, logits_p = tv.vit_head_train_plain(*args)
    tol = TF_TOL["rtol"] if dtype == "bfloat16" else 2e-4
    torch.testing.assert_close(logits, logits_p, rtol=tol, atol=tol)
    torch.testing.assert_close(loss, lp, rtol=tol, atol=tol)
    g = torch.tensor(1.0, device=dev)
    got = _counted("vit_head_train", tv.vit_head_train_bwd, *args, logits_p, g)
    want = tv.vit_head_train_bwd_plain(*args, logits_p, g)
    assert not bool(got[0][:, 1:].any())
    for a, w in zip(got, want):
        if dtype == "float32":
            torch.testing.assert_close(a.float(), w.float(), rtol=1e-4, atol=1e-5)
        else:
            assert float((a.float() - w.float()).norm() / w.float().norm()) <= 1e-2
    again = tv.vit_head_train_bwd(*args, logits_p, g)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_bwd_matches_plain(dev, dtype):
    rng = np.random.default_rng(55)
    dx = _on(dev, rng.normal(size=(7, 197, 768)).astype(np.float32)).to(DTYPES[dtype])
    got = _counted("vit_embed_bwd", tv.vit_embed_bwd, dx)
    want = tv.vit_embed_bwd_plain(dx)
    for a, w in zip(got, want):
        assert a.shape == w.shape and a.dtype == torch.float32
        tol = 1e-5 if dtype == "float32" else 1e-2
        torch.testing.assert_close(a, w, rtol=tol, atol=tol)
    assert all(torch.equal(a, c) for a, c in zip(got, tv.vit_embed_bwd(dx)))


def test_vit_train_form_matches_plain(dev):
    """The ViT's loss and gradients on the card, every kernel of the path
    launched (KP, KV, KL, KA, KU, KT's train mode, the backward kernels):
    a label past the classes makes both losses NaN, the gradients finite;
    f32 gradients per element against the plain version's; bf16
    gradients each within 2e-2 relative norm of the f32 plain gradient or
    1.25x the plain bf16 gradient's own error (attn.wk.b's against its
    block's attn.wq.b gradient: its exact gradient is 0)."""
    cfg32, params, images, labels = _vit_train_case(dev, "float32")

    def grads(cfg, fn):
        return tc.value_and_grad(lambda p: fn(p, cfg, images, labels), params)

    kernels.reset_launches()
    lk, gk = grads(cfg32, tv.loss)
    counts = kernels.launches()
    d = cfg32.depth
    want = {"frame_patches": 1, "vit_embed": 1, "layernorm": 2 * d, "attention": d,
            "bias_gelu": d, "vit_head_train": 2, "attention_bwd": d, "layernorm_bwd": 2 * d,
            "bias_gelu_bwd": d, "vit_embed_bwd": 1}
    assert {k: counts[k] for k in want} == want
    lp, gp = grads(cfg32, tv.loss_plain)
    # label 1000 is past the classes: the loss is NaN, as the reference's
    assert bool(torch.isnan(lk)) and bool(torch.isnan(lp))
    names = _leaf_names(params)
    flat_k, flat_p = tc.tree_leaves(gk), tc.tree_leaves(gp)
    for name, a, b in zip(names, flat_k, flat_p):
        assert bool(torch.isfinite(a).all()), name
        if not name.endswith("wk/b"):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * max(1.0, float(b.abs().max())))
    cfg16 = dataclasses.replace(cfg32, dtype="bfloat16")
    _, gk16 = grads(cfg16, tv.loss)
    _, gp16 = grads(cfg16, tv.loss_plain)
    ref = dict(zip(names, flat_p))
    for name, a, b, w in zip(names, tc.tree_leaves(gk16), tc.tree_leaves(gp16), flat_p):
        scale = ref[name.replace("wk/b", "wq/b")].norm() if name.endswith("wk/b") else w.norm()
        err_k, err_p = (float((g - w).norm() / scale) for g in (a, b))
        assert err_k <= max(2e-2, 1.25 * err_p), (name, err_k, err_p)
    _, again = grads(cfg16, tv.loss)
    assert all(torch.equal(a, b) for a, b in zip(tc.tree_leaves(gk16), tc.tree_leaves(again)))


def test_train_step_runs_the_port_adam_as_ko(dev):
    """``apply_step`` (every family's ``train_step``) with ``adam(lr)`` and
    with ``scale_by_adam()`` on CUDA tensors: one KO call, in place, within
    one f32 ulp of KO's plain version on the tree as one slot (lr, or -1
    for ``scale_by_adam``, whose fma(1, u, p) is exactly p + u); a T past
    KA's backward cap raises before any launch."""
    cfg, params, images, labels = _vit_train_case(dev, "float32")
    _, grads = tc.value_and_grad(lambda p: tv.loss(p, cfg, images, labels), params)

    def one(tree):
        return tc.tree_map(lambda x: x[None], tree)

    for opt, lr in ((adam.adam(1e-3), 1e-3), (adam.scale_by_adam(), -1.0)):
        pk, twin = tc.tree_map(torch.clone, params), tc.tree_map(torch.clone, params)
        sk, st = opt.init(pk), opt.init(twin)
        st = st if isinstance(st, adam.AdamState) else st[0]
        before = kernels.launches()["adam_update"]
        pk2, sk2 = adam.apply_step(opt, pk, grads, sk)
        assert kernels.launches()["adam_update"] == before + 1 and pk2 is pk
        adam.adam_update_plain(one(twin), one(grads), adam.AdamState(
            st.count.reshape(1), one(st.mu), one(st.nu)), torch.full((1,), lr, device=dev),
            torch.ones(1, dtype=torch.bool, device=dev))
        torch.cuda.synchronize()
        for a, b in zip(tc.tree_leaves(pk2), tc.tree_leaves(twin)):
            assert int((a.view(torch.int32).long() - b.view(torch.int32).long()).abs().max()) <= 1
    # KA's backward past the staged form's shared memory (f32 hd 64, T
    # 210) goes to the tiled form, before any launch of the staged one
    rng = np.random.default_rng(71)
    q, k, v, do = (_rand(dev, rng, (1, 210, 768), "float32") for _ in range(4))
    before = kernels.launches()["attention_bwd"]
    got = _counted("attention_tiled_bwd", tc.attention_bwd, q, k, v, do, 12, False)
    assert kernels.launches()["attention_bwd"] == before
    for a, b in zip(got, tc.attention_bwd_plain(q, k, v, do, 12, False)):
        _held_train(a, b, "float32")


@pytest.mark.parametrize("family", ["lstm_ad", "deepar"])
def test_per_tenant_loss_launches_the_train_kernel(dev, family):
    """LSTM-AD's and DeepAR's per-tenant ``loss`` on CUDA tensors: KB or KR
    over one slot, within the f32 bar of the plain composition on the
    CPU."""
    spec = get_model(family)
    cfg = make_config(family, {"hidden": 16, "window": 12, "context": 12, "dtype": "float32"})
    params = spec.init(torch.Generator().manual_seed(3), cfg, device=dev)
    rng = np.random.default_rng(4)
    windows = np.cumsum(rng.normal(size=(24, 12)), -1).astype(np.float32)
    name = {"lstm_ad": "lstm_train", "deepar": "gru_train"}[family]
    got = _counted(name, spec.loss, params, cfg, _on(dev, windows))
    want = spec.loss(tc.tree_map(lambda x: x.cpu(), params), cfg, torch.from_numpy(windows))
    torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)


# -- the transformer's weight formats and KA's tiled form -----------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kq_matches_plain_bitwise(dev, dtype):
    """KQ (``dequant_weight``, the kernel path's read of an int8 node)
    bitwise its plain version ``kernel_weight``'s dequant, stacked and
    single, O a multiple of 4 and not."""
    rng = np.random.default_rng(80)
    for shape in [(3, 128, 512), (2, 7, 5), (16, 9)]:
        w = _on(dev, rng.normal(size=shape).astype(np.float32))
        node = tc.quantize_dense({"w": w, "b": torch.zeros(shape[-1], device=dev)}, "int8")
        got = _counted("dequant", tc.dequant_weight, node, DTYPES[dtype])
        want = tc.dequant_plain(node["qw"], node["scale"], DTYPES[dtype])
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("param_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ke_and_kn_formats_match_plain(dev, dtype, param_dtype):
    """KE (windows, ring and context modes) and KN (score and forecast
    modes) reading each weight format, against their plain versions on the
    same tree, each launch counted under its format."""
    cfg = make_config("transformer", {"dtype": dtype, "context": 64})
    params = tc.quantize_params(_tf_stack(dev, cfg, 3), param_dtype)
    rng = np.random.default_rng(81)
    wins = _on(dev, rng.normal(size=(3, 40, 32)).astype(np.float32))
    nv = _on(dev, rng.integers(2, 33, (3, 40)).astype(np.int32))
    kernels.reset_launches()
    xk, tk, nk = tt.tf_embed(params, cfg, 3, windows=wins, n_valid=nv)
    xp, tp, np_ = tt.tf_embed_plain(params, cfg, 3, windows=wins, n_valid=nv)
    _tokens_close(xk, xp, np_)
    got = tt.tf_head(params, cfg, xp, tp, np_, 3)
    torch.testing.assert_close(got, tt.tf_head_plain(params, cfg, xp, tp, np_, 3), **TF_TOL)
    one = tc.tree_map(lambda x: x[:1], params)
    raw = _on(dev, (5 + np.sin(np.arange(80)[None] / 4 + np.arange(6)[:, None])).astype(np.float32))
    xk, ck, mk, sk = tt.tf_embed_context(one, cfg, raw=raw)
    xp, cp, mp, sp = tt.tf_embed_context_plain(one, cfg, raw=raw)
    torch.testing.assert_close(xk.float(), xp.float(), **TF_TOL)
    outs = []
    for fn in (tt.tf_head_forecast, tt.tf_head_forecast_plain):
        nxt, smp, mns = torch.zeros_like(cp), torch.zeros((6, 2), device=dev), torch.zeros(
            (6, 2), device=dev)
        fn(one, cfg, xp, cp, nxt, torch.ones(6, device=dev), mp, sp, smp, mns, 0)
        outs.append((nxt, smp, mns))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, **TF_TOL)
    variants = kernels.variant_launches()
    assert variants[f"tf_embed[{param_dtype}]"] == 2 and variants[f"tf_head[{param_dtype}]"] == 2
    if param_dtype == "bf16" and dtype == "bfloat16":  # bf16 storage: the masters' bits
        masters = _tf_stack(dev, cfg, 3)
        assert torch.equal(tt.tf_embed(params, cfg, 3, windows=wins, n_valid=nv)[0],
                           tt.tf_embed(masters, cfg, 3, windows=wins, n_valid=nv)[0])


# (N, T, heads, hd, causal): the reference's test widths, ViT-H/14's head,
# f32 hd 64 past the staged form's caps, a long causal context, wide heads;
# the bf16 tensor-core tiles' edges (64-row query and key tiles: T 63, 64,
# 65, 129, causal and not), head dims that are no multiple of 16 (100,
# 200) and the widest head at ViT-B/16-384's length
TILED_SHAPES = [(3, 11, 2, 8, True), (2, 15, 2, 16, True), (2, 257, 2, 80, False),
                (2, 210, 2, 64, True), (1, 600, 2, 32, True), (2, 255, 1, 128, True),
                (2, 40, 1, 256, False), (4, 5, 3, 1, True),
                (2, 63, 2, 64, True), (2, 63, 2, 64, False), (2, 64, 2, 64, True),
                (2, 64, 2, 64, False), (2, 65, 2, 64, True), (2, 65, 2, 64, False),
                (2, 129, 2, 64, True), (2, 129, 2, 64, False), (2, 100, 2, 100, True),
                (2, 77, 1, 200, False), (1, 577, 1, 256, False)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiled_ka_matches_plain(dev, dtype):
    """KA's tiled forward and backward at head dims 1 to 256 and T past the
    staged form's caps, against the plain versions (forward: 2e-4 in f32,
    the bf16 bar; backward: ``_held_train``'s bars), two runs bitwise, bf16
    also by ``_held_f64`` (its fault twin shown failing); ``attention``
    and ``attention_bwd`` route these shapes to it."""
    rng = np.random.default_rng(82)
    tol = dict(rtol=2e-4, atol=2e-4) if dtype == "float32" else TF_TOL
    for n, t, heads, hd, causal in TILED_SHAPES:
        q, k, v, do = (_rand(dev, rng, (n, t, heads * hd), dtype, 1.5) for _ in range(4))
        route = tc.attn_route(False, DTYPES[dtype], hd, t)
        got = tc.attention(q, k, v, heads, causal)
        assert route == "tiled" or hd in (32, 64)
        torch.testing.assert_close(got.float(), tc.attention_plain(q, k, v, heads, causal).float(),
                                   **tol)
        tiled = _counted("attention_tiled", tc.attention_tiled, q, k, v, heads, causal)
        assert torch.equal(tiled, tc.attention_tiled(q, k, v, heads, causal))
        grads = _counted("attention_tiled_bwd", tc.attention_tiled_bwd, q, k, v, do, heads,
                         causal)
        for a, b in zip(grads, tc.attention_bwd_plain(q, k, v, do, heads, causal)):
            _held_train(a, b, dtype)
        again = tc.attention_tiled_bwd(q, k, v, do, heads, causal)
        assert all(torch.equal(a, b) for a, b in zip(grads, again))
        if dtype == "bfloat16":
            _held_f64((tiled, *grads), q, k, v, do, heads, causal)
    # the staged forms keep every shape they took
    x = _rand(dev, rng, (2, 197, 768), dtype)
    _counted("attention", tc.attention, x, x, x, 12, False)
    _counted("attention_bwd", tc.attention_bwd, x, x, x, x, 12, False)


def _held_f64(got, q, k, v, do, heads, causal):
    """bf16 KA outputs (out, dq, dk, dv; tiled or split) by their mean abs error
    against the float64 plain version: at most 1.25x the bf16 plain
    version's + 1e-3 (``chip_smoke.tiled_f64_accuracy``); the twin with its
    mask faulted on the last key tile (``chip_smoke.tiled_fault_t0``:
    causal, those keys escape it; else the last 64 keys dropped) fails."""
    import chip_smoke

    plain = (tc.attention_plain(q, k, v, heads, causal),
             *tc.attention_bwd_plain(q, k, v, do, heads, causal))
    w = [x.double() for x in (q, k, v, do)]
    ref = (tc.attention_plain(*w[:3], heads, causal), *tc.attention_bwd_plain(*w, heads, causal))
    acc = chip_smoke.tiled_f64_accuracy(got, plain, ref)
    assert acc["ok"], acc
    t0 = chip_smoke.tiled_fault_t0(q.shape[1], causal)
    fo, fg = chip_smoke.tiled_fault_twin(q, k, v, do, heads, causal, t0)
    fault = chip_smoke.tiled_f64_accuracy((fo, *fg), plain, ref)
    assert not fault["ok"], fault


@pytest.mark.parametrize("causal", [True, False])
def test_tiled_ka_bf16_accurate_vs_f64(dev, causal):
    """KA's bf16 tiled forward and backward (tensor cores) at 8 x 577 x 2 x
    64 held by ``_held_f64``."""
    rng = np.random.default_rng(83)
    n, t, heads, hd = 8, 577, 2, 64
    q, k, v, do = (_rand(dev, rng, (n, t, heads * hd), "bfloat16", 1.5) for _ in range(4))
    got = (_counted("attention_tiled", tc.attention_tiled, q, k, v, heads, causal),
           *_counted("attention_tiled_bwd", tc.attention_tiled_bwd, q, k, v, do, heads, causal))
    _held_f64(got, q, k, v, do, heads, causal)


STAGED_BOUNDARY_T = (1, 8, 16, 17, 31, 32, 33, 64, 65, 128, 197, 391, 416, 512)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [32, 64])
def test_staged_ka_bf16_at_boundary_t(dev, hd, causal):
    """The bf16 staged KA (tensor cores) at the T where its packing and
    tiles change and at its caps: forward and backward held by
    ``_held_f64`` (the causal leak failing), the packed tile's leak
    (``chip_smoke.staged_pack_fault_twin``) failing it at T <= 32, two runs
    bitwise; launched by ``attention`` (and ``attention_bwd`` where
    ``attn_route`` keeps the backward staged: T <= 416 at hd 64)."""
    import chip_smoke

    rng = np.random.default_rng(84 + hd)
    heads = 2 if hd == 64 else 4
    for t in STAGED_BOUNDARY_T:
        n = max(1, 8192 // (t * heads))
        q, k, v, do = (_rand(dev, rng, (n, t, heads * hd), "bfloat16", 1.5) for _ in range(4))
        staged_bwd = tc.attn_route(True, torch.bfloat16, hd, t) == "staged"
        out = _counted("attention", tc.attention, q, k, v, heads, causal)
        grads = (_counted("attention_bwd", tc.attention_bwd, q, k, v, do, heads, causal)
                 if staged_bwd else tc.attention_bwd(q, k, v, do, heads, causal))
        assert torch.equal(out, tc.attention(q, k, v, heads, causal))
        assert all(torch.equal(a, b) for a, b in zip(
            grads, tc.attention_bwd(q, k, v, do, heads, causal)))
        if t > 1:  # one key: every output is exact
            _held_f64((out, *grads), q, k, v, do, heads, causal)
        if 2 <= t <= 32:
            plain = (tc.attention_plain(q, k, v, heads, causal),
                     *tc.attention_bwd_plain(q, k, v, do, heads, causal))
            w = [x.double() for x in (q, k, v, do)]
            ref = (tc.attention_plain(*w[:3], heads, causal),
                   *tc.attention_bwd_plain(*w, heads, causal))
            fo, fg = chip_smoke.staged_pack_fault_twin(q, k, v, do, heads, causal)
            assert not chip_smoke.tiled_f64_accuracy((fo, *fg), plain, ref)["ok"]


@pytest.mark.parametrize("n, t, heads, hd, causal", [(65536, 31, 4, 32, True),
                                                     (64, 197, 12, 64, False),
                                                     (128, 128, 4, 32, True)])
def test_staged_ka_bf16_at_main_path_shapes(dev, n, t, heads, hd, causal):
    """The bf16 staged KA at transformer32's, ViT-B/16-224's and the
    transformer forecast's (T 128) shapes, whole: its outputs on the first
    sequences held by ``_held_f64``, every output finite."""
    rng = np.random.default_rng(85)
    q, k, v, do = (_rand(dev, rng, (n, t, heads * hd), "bfloat16", 1.5) for _ in range(4))
    out = _counted("attention", tc.attention, q, k, v, heads, causal)
    grads = _counted("attention_bwd", tc.attention_bwd, q, k, v, do, heads, causal)
    assert all(bool(torch.isfinite(x.float()).all()) for x in (out, *grads))
    m = min(n, 2048)
    _held_f64(tuple(x[:m] for x in (out, *grads)), q[:m], k[:m], v[:m], do[:m], heads, causal)


@pytest.mark.parametrize("param_dtype", ["bf16", "int8"])
def test_quantized_transformer_scorer_matches_plain_twin(dev, param_dtype):
    """``ShardedScorer(family="transformer", param_dtype=...)`` on the card
    against its plain twin at f32 compute: state bitwise, scores per row at
    2e-4; KE, KN in the tree's format, KQ for int8."""
    spec, cfg = get_model("transformer"), make_config("transformer", {"depth": 2,
                                                                     "dtype": "float32"})
    mk = lambda plain: ShardedScorer(  # noqa: E731
        MeshManager(device=dev), spec, cfg, slots_per_shard=3, max_streams=512, window=32,
        param_dtype=param_dtype, plain=plain)
    kern, twin = mk(False), mk(True)
    own = _tf_stack(dev, cfg, 3)
    for sc in (kern, twin):
        for slot in range(3):
            sc.activate(slot, params=tc.tree_map(lambda x: x[slot], own))
    rng = np.random.default_rng(83)
    kernels.reset_launches()
    for _ in range(4):
        ids = rng.integers(0, 400, (3, 256)).astype(np.uint16)
        vals = rng.normal(size=(3, 256)).astype(np.float32)
        counts = np.array([[256], [100], [0]], np.int32)
        got = kern.step_counts(*kern.stage_inputs(ids, vals, counts)).numpy_f32()
        want = twin.step_counts(ids, vals, counts).numpy_f32()
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert all(torch.equal(a, b) for a, b in zip(kern.state, twin.state))
    variants = kernels.variant_launches()
    assert variants[f"tf_embed[{param_dtype}]"] == variants[f"tf_head[{param_dtype}]"] == 4
    assert kernels.launches()["dequant"] == (4 * 12 if param_dtype == "int8" else 0)


# -- KE's raw form, KA's split form, KT's sort and bf16-weight forms ------------------

@pytest.mark.parametrize("length", [4097, 86400])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ke_raw_form_matches_plain(dev, dtype, length):
    """KE's raw form over raw histories past 4,096 values (the route sends
    them there): the context, mu and sigma within 2e-4 of a float64
    normalization, the tokens within the bar of the plain version, two runs
    bitwise."""
    cfg = make_config("transformer", {"dtype": dtype})
    one = tc.tree_map(lambda a: a[None], tt.init(torch.Generator().manual_seed(4), cfg, dev))
    gen = torch.Generator(dev).manual_seed(length)
    t = torch.arange(length, device=dev, dtype=torch.float32)
    raw = (21 + 4 * torch.sin(t / 13750)[None] + 0.3 * torch.randn(
        (5, length), generator=gen, device=dev)).contiguous()
    assert tt.ke_raw_route(length) == "raw"
    kernels.reset_launches()
    x, ctx, mu, sigma = tt.tf_embed_context(one, cfg, raw=raw)
    assert kernels.launches()["tf_embed_raw"] == 1
    n64, mu64, sg64 = tc.normalize_windows(raw.double())
    torch.testing.assert_close(ctx.double(), tt._context(n64, cfg.context), rtol=2e-4,
                               atol=2e-4)
    torch.testing.assert_close(mu.double(), mu64[:, 0], rtol=0, atol=2e-4 * float(sg64.min()))
    torch.testing.assert_close(sigma.double(), sg64[:, 0], rtol=2e-4, atol=0)
    xp = tt.tf_embed_context_plain(one, cfg, raw=raw)[0]
    tol = 2e-2 if dtype == "bfloat16" else 2e-4
    torch.testing.assert_close(x.float(), xp.float(), rtol=tol, atol=tol)
    for a, b in zip((x, ctx, mu, sigma), tt.tf_embed_context(one, cfg, raw=raw)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("hd, t, causal", [(288, 31, True), (300, 31, True), (512, 197, False),
                                           (257, 40, False), (320, 64, True), (320, 65, True),
                                           (300, 197, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_attention_matches_plain(dev, dtype, hd, t, causal):
    """KA's split form forward and backward at head dims 257 (element by
    element copies), 288 (two heads), 300, 320 and 512, at one key tile (T
    31, 40, 64), just past it (65) and at 197: f32 within 2e-4 of the
    float64 plain version, bf16 within 1e-2 relative norm of the plain
    version and by ``_held_f64`` (tensor cores), two runs bitwise."""
    heads = 2 if hd == 288 else 1
    gen = torch.Generator(dev).manual_seed(hd)
    q, k, v, do = (torch.randn((16, t, heads * hd), generator=gen, device=dev)
                   .to(DTYPES[dtype]) for _ in range(4))
    kernels.reset_launches()
    o = tc.attention(q, k, v, heads, causal)
    g = tc.attention_bwd(q, k, v, do, heads, causal)
    assert kernels.launches()["attention_split"] == kernels.launches()["attention_split_bwd"] == 1
    if dtype == "float32":
        want = tc.attention_plain(*(a.double() for a in (q, k, v)), heads, causal)
        torch.testing.assert_close(o.double(), want, rtol=2e-4, atol=2e-4)
        for a, w in zip(g, tc.attention_bwd_plain(*(x.double() for x in (q, k, v, do)), heads,
                                                  causal)):
            torch.testing.assert_close(a.double(), w, rtol=2e-4,
                                       atol=2e-4 * max(1.0, float(w.abs().max())))
    else:
        def rel(a, b):
            return float((a.float() - b.float()).norm() / b.float().norm())

        assert rel(o, tc.attention_plain(q, k, v, heads, causal)) <= 1e-2
        for a, w in zip(g, tc.attention_bwd_plain(q, k, v, do, heads, causal)):
            assert rel(a, w) <= 1e-2
        _held_f64((o, *g), q, k, v, do, heads, causal)
    assert torch.equal(o, tc.attention(q, k, v, heads, causal))
    for a, b in zip(g, tc.attention_bwd(q, k, v, do, heads, causal)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("wdtype", ["f32", "bf16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kt_any_k_and_bf16_head_match_plain(dev, dtype, wdtype):
    """KT at top-k 5, 64 (argmax rounds), 65, 100 and 1,000 (the sort) on
    an f32 or bf16-stored head with 100 exactly tied class pairs: the logits
    within the bar of the plain version, the ids and probabilities of a
    top-k the plain top-k of KT's own logits, ties lower index first, the
    first 64 of a top-1,000 bitwise the top-64; at bf16 compute the bf16
    head bitwise the f32 one."""
    gen = torch.Generator(dev).manual_seed(11)
    d, c = 768, 1000
    x = torch.randn((8, 3, d), generator=gen, device=dev).to(DTYPES[dtype])
    ln = {"scale": 1 + 0.1 * torch.randn(d, generator=gen, device=dev),
          "bias": 0.1 * torch.randn(d, generator=gen, device=dev)}
    w = 0.05 * torch.randn((d, c), generator=gen, device=dev)
    b = 0.1 * torch.randn(c, generator=gen, device=dev)
    w[:, 900:], b[900:] = w[:, :100], b[:100]
    head = {"w": w.to(torch.bfloat16 if wdtype == "bf16" else torch.float32), "b": b}
    outs = {}
    for k in (5, 64, 65, 100, 1000):
        kernels.reset_launches()
        lg, pr, ids = tv.vit_head(x, ln, head, k)
        form = "sort" if k > 64 else "argmax"
        assert kernels.variant_launches() == {f"vit_head[{form},{wdtype}]": 1}
        tol = 2e-2 if dtype == "bfloat16" else 2e-4
        torch.testing.assert_close(lg, tv.vit_head_plain(x, ln, head, 0)[0], rtol=tol, atol=tol)
        pp, ip = tv.softmax_topk_plain(lg, k)
        torch.testing.assert_close(pr, pp, rtol=1e-5, atol=1e-7)
        # the plain softmax sums in another order: ids may swap only where
        # two neighbouring probabilities are within its rounding
        near = torch.zeros_like(ids, dtype=torch.bool)
        close = (pp[:, 1:] - pp[:, :-1]).abs() <= 1e-6 * pp[:, :-1]
        near[:, 1:] |= close
        near[:, :-1] |= close
        assert not bool(((ids != ip) & ~near).any())
        outs[k] = (lg, pr, ids)
    assert torch.equal(outs[1000][1][:, :64], outs[64][1])
    assert torch.equal(outs[1000][2][:, :64], outs[64][2])
    pos = torch.argsort(outs[1000][2].long(), dim=1)
    assert bool((pos[:, :100] < pos[:, 900:]).all())
    if dtype == "bfloat16" and wdtype == "bf16":
        for a, b_ in zip(outs[5], tv.vit_head(x, ln, {"w": w, "b": b}, 5)):
            assert torch.equal(a, b_)
    with pytest.raises(ValueError, match="top-k"):
        tv.vit_head(x, ln, head, c + 1)


def test_kt_sort_keys_in_global_scratch(dev):
    """KT's sort past top-64 where the classes' keys do not fit shared
    memory (30,000 classes: 32,768 keys a frame in a scratch row): the
    ids and probabilities of the plain top-k of KT's own logits."""
    gen = torch.Generator(dev).manual_seed(12)
    d, c = 64, 30000
    assert tv.kt_sort_keys(d, c) == (32768, False)
    x = torch.randn((4, 1, d), generator=gen, device=dev)
    ln = {"scale": torch.ones(d, device=dev), "bias": torch.zeros(d, device=dev)}
    head = {"w": torch.randn((d, c), generator=gen, device=dev), "b": torch.zeros(c, device=dev)}
    lg, pr, ids = tv.vit_head(x, ln, head, 300)
    pp, ip = tv.softmax_topk_plain(lg, 300)
    torch.testing.assert_close(pr, pp, rtol=1e-5, atol=1e-9)
    assert torch.equal(ids, ip)


# K14: KA's ring step, in place on the running statistics, against its plain
# version: the causal ring's mask regimes (the diagonal, a fully visible and
# a fully masked block, unequal offsets) and non-causal, at head dims 1..256
# and block lengths that are not a multiple of the kernel's 64-row tiles
@pytest.mark.parametrize("b, tl, h, hd, q_off, k_off, causal", [
    (2, 300, 4, 32, 300, 300, True), (2, 300, 4, 32, 600, 0, True),
    (2, 300, 4, 32, 0, 600, True), (2, 300, 4, 32, 0, 300, False),
    (3, 197, 3, 64, 197, 100, True), (1, 130, 2, 256, 130, 130, True),
    (2, 33, 1, 1, 0, 0, True), (2, 65, 2, 80, 65, 0, False)])
def test_ring_step_matches_plain(dev, b, tl, h, hd, q_off, k_off, causal):
    from sitewhere_tpu_torch.ops import ring_attention as tra

    gen = torch.Generator(device=dev).manual_seed(hd)
    q, k, v, k0, v0 = (torch.randn((b, tl, h, hd), generator=gen, device=dev) for _ in range(5))
    state = [torch.full((b, h, tl), tra.NEG_INF, device=dev), torch.zeros((b, h, tl), device=dev),
             torch.zeros((b, h, tl, hd), device=dev)]
    tra.ring_step_plain(q, k0, v0, *state, q_off, q_off, causal)
    got, want = ([x.clone() for x in state] + [torch.empty_like(q)] for _ in range(2))
    kernels.reset_launches()
    tra.ring_step(q, k, v, *got[:3], q_off, k_off, causal, got[3])
    assert kernels.launches()["attention_ring"] == 1
    tra.ring_step_plain(q, k, v, *want[:3], q_off, k_off, causal, want[3])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-4)
    if causal and k_off > q_off + tl - 1:  # fully masked: the state bitwise as it was
        assert all(torch.equal(g, s) for g, s in zip(got[:3], state))


def test_ring_step_refuses_what_it_does_not_take(dev):
    from sitewhere_tpu_torch.ops import ring_attention as tra

    for dtype, hd in ((torch.bfloat16, 32), (torch.float32, 257)):
        q = torch.zeros((1, 8, 1, hd), device=dev, dtype=dtype)
        m, l = torch.zeros((1, 1, 8), device=dev, dtype=dtype), torch.zeros((1, 1, 8), device=dev,
                                                                            dtype=dtype)
        acc = torch.zeros((1, 1, 8, hd), device=dev, dtype=dtype)
        with pytest.raises(NotImplementedError, match="ROADMAP queue 2"):
            tra.ring_step(q, q, q, m, l, acc, 0, 0, True)

"""Port parity: the ViT-B/16 frame classifier and the compressed wire's
decode (``sitewhere_tpu_torch.models.vit``, ``ops.dct``,
``services.streaming_media``; the plain versions of kernels KP, KJ, KV and
KT) against ``sitewhere_tpu`` on identical numpy inputs and one param tree
carried across as numpy.

Bars: the decode within 1e-3 on the 0..255 scale (the f32 IDCT's
reassociation; the reference's f32 decode is within 7.2e-5 of a float64
one); patches and the u8 wire's bf16 patches bitwise; logits the
reference's transformer bars (``tests/test_fused_step.py``), float32 2e-4
(``:144``), bfloat16 2e-2 (``:110``); the top-k by the tie-tolerant rule
of ``chip_smoke.topk_agreement`` at the same bars. The coefficients come
from ``chip_smoke.encode_frames`` (a numpy JPEG encoder: the card's
machine has no PIL) over the shared synthetic camera frames."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import sitewhere_tpu.models.common as jc
import sitewhere_tpu.ops.dct as jd
import sitewhere_tpu.services.streaming_media as js
import sitewhere_tpu.sim.media as jsim
import sitewhere_tpu_torch.models as tm
import sitewhere_tpu_torch.models.common as tc
import sitewhere_tpu_torch.models.vit as tv
import sitewhere_tpu_torch.ops.dct as td
import sitewhere_tpu_torch.services.streaming_media as ts
import sitewhere_tpu_torch.sim.media as tsim
from sitewhere_tpu.models import vit as jv

TOL = {"float32": 2e-4, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# the tiny config at a frame size whose 4:2:0 MCU grid (48 x 48) pads past
# the crop (40 x 40), so the chroma upsample's edge is the padded plane's
PADDED = dict(image_size=40, patch_size=8, dim=64, depth=2, heads=2, num_classes=10)

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _params_np(cfg, seed=0):
    """A JAX ViT tree as numpy, every 1-D leaf (dense biases, LayerNorm
    scales and biases) moved off its init value by 0.05 N(0, 1), so every
    bias and affine path is exercised."""
    rng = np.random.default_rng(seed)
    p = jax.tree_util.tree_map(np.array, jv.init(jax.random.PRNGKey(seed), cfg))
    return jax.tree_util.tree_map(
        lambda x: (x + 0.05 * rng.normal(size=x.shape)).astype(np.float32) if x.ndim == 1 else x, p)


def _configs(dtype, **over):
    kw = {**PADDED, **over, "dtype": dtype}
    return jv.ViTConfig(**kw), tv.ViTConfig(**kw)


def _frames(size, n, seed=5):
    return np.stack(tsim.camera_frames(size, n, seed))


def _wire(frames, sub, k=None):
    planes, lay, _ = chip_smoke.encode_frames(frames, sub)
    if k is not None:
        planes, lay = chip_smoke.truncated(planes, lay, k)
    return planes, lay


def test_layout_helpers_and_sim_are_the_references():
    assert np.array_equal(td.ZIGZAG, jd.ZIGZAG) and td.COEF_BUCKETS == jd.COEF_BUCKETS
    assert [td.coef_bucket(k) for k in range(70)] == [jd.coef_bucket(k) for k in range(70)]
    assert np.array_equal(td.idct_basis(), jd.idct_basis())
    for k in td.COEF_BUCKETS:
        assert np.array_equal(td.dezigzag_matrix(k), jd.dezigzag_matrix(k))
    for w, h, sub, k in [(224, 224, 2, 32), (40, 24, 2, 8), (50, 30, 1, 64)]:
        lt, lj = td.layout_for(w, h, sub, k), jd.layout_for(w, h, sub, k)
        assert tuple(lt) == tuple(lj) and lt.wire_bytes(3) == lj.wire_bytes(3)
        assert td.decode_flops_per_frame(lt) == jd.decode_flops_per_frame(lj)
    for a, b in zip(tsim.camera_frames(24, 3), jsim.camera_frames(24, 3)):
        assert a.dtype == np.uint8 and np.array_equal(a, b)
    from sitewhere_tpu_torch.core.model import new_token

    tok = new_token("stream")
    assert tok.startswith("stream-") and len(tok) == 19 and new_token() != new_token()


@pytest.mark.parametrize("k", [8, 16, 32, 64])
@pytest.mark.parametrize("sub", [1, 2])
def test_decode_frames_matches_reference(sub, k):
    """decode_frames on a 44 x 28 layout whose grid (48 x 32) pads past the
    crop, and KJ's RGB and patches (its plain version on the CPU) on a
    40 x 24 one, from coefficients of camera frames truncated at k."""
    frames = _frames(48, 3)
    for w, h in ((44, 28), (40, 24)):
        (y, cb, cr), lay = _wire(frames[:, :h, :w], sub, k)
        want = np.asarray(jd.decode_frames(jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr),
                                           jd.FrameLayout(*lay)))
        tl = td.FrameLayout(*lay)
        got = td.decode_frames(_t(y), _t(cb), _t(cr), tl).numpy()
        assert got.shape == want.shape == (3, h, w, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    assert (td.layout_for(44, 28, sub, k).y_gw, td.layout_for(44, 28, sub, k).y_gh) == (6, 4)
    patches, rgb = td.decode_rgb(_t(y), _t(cb), _t(cr), tl, 8, torch.float32)
    np.testing.assert_allclose(rgb.numpy(), want, rtol=0, atol=1e-3)
    np.testing.assert_allclose(patches.numpy(),
                               np.asarray(jv.patchify((want / 255.0 - 0.5) / 0.5, 8)),
                               rtol=0, atol=1e-5)


def test_encoder_round_trip_and_extent():
    """The encoder's coefficients decode back to the frames within JPEG's
    quantization error, and the camera content's extent stays below 64."""
    frames = _frames(48, 2)
    for sub in (1, 2):
        (y, cb, cr), lay, extent = chip_smoke.encode_frames(frames, sub)
        assert lay.k == td.coef_bucket(extent) and y.dtype == np.int16
        rgb = td.decode_frames(_t(y), _t(cb), _t(cr), lay).numpy()
        err = np.abs(rgb - frames)
        assert err.mean() < 6 and np.percentile(err, 99) < 25, (sub, err.mean())
    assert extent < 64


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_patches_match_reference(dtype):
    """patchify bitwise; the u8 wire's patches (normalized as the reference
    jits it, then cast): bitwise in bf16 over all 256 u8 values, within one
    f32 ulp in f32."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(3)
    images = rng.normal(size=(2, 40, 40, 3)).astype(np.float32)
    assert np.array_equal(tv.patchify(_t(images), 8).numpy(), np.asarray(jv.patchify(images, 8)))
    frames = rng.integers(0, 256, (2, 40, 40, 3)).astype(np.uint8)
    frames[0].reshape(-1)[:256] = np.arange(256)
    want = np.asarray(jax.jit(lambda x: jv.patchify((x.astype(jnp.float32) / 255.0 - 0.5) / 0.5, 8)
                              .astype(jdt))(jnp.asarray(frames))).astype(np.float32)
    got = tv.frame_patches(_t(frames), 8, tdt).float().numpy()
    assert got.shape == (2, 25, 192)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1.2e-7)
    f32 = tv.frame_patches(_t(images), 8, tdt).float().numpy()
    np.testing.assert_array_equal(f32, np.asarray(jv.patchify(images, 8).astype(jdt))
                                  .astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_matches_reference(dtype):
    jcfg, tcfg = _configs(dtype)
    pn = _params_np(jcfg)
    rng = np.random.default_rng(4)
    images = rng.normal(size=(3, 40, 40, 3)).astype(np.float32)
    want = np.asarray(jv.apply(pn, jcfg, jnp.asarray(images)))
    tp = tc.params_from_numpy(pn, "cpu")
    got = tv.apply(tp, tcfg, _t(images))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 10)
    _close(got.numpy(), want, TOL[dtype])
    # the plain twin runs the same composition over the plain versions
    assert torch.equal(tv.classify_plain(tp, tcfg, _t(images), 0)[0], got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sub", [1, 2])
def test_apply_dct_matches_reference(dtype, sub):
    jcfg, tcfg = _configs(dtype)
    pn = _params_np(jcfg, seed=1)
    (y, cb, cr), lay = _wire(_frames(40, 3), sub)
    want = np.asarray(jv.apply_dct(pn, jcfg, jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr),
                                   jd.FrameLayout(*lay)))
    tp = tc.params_from_numpy(pn, "cpu")
    got = tv.apply_dct(tp, tcfg, _t(y), _t(cb), _t(cr), td.FrameLayout(*lay)).numpy()
    _close(got, want, TOL[dtype])
    with pytest.raises(ValueError, match="decode to"):
        tv.apply_dct(tp, tcfg, _t(y), _t(cb), _t(cr), td.FrameLayout(*lay)._replace(width=32))


def _op_by_op(pn, cfg, frames=None, wire=None):
    """The reference service's computation (normalize, apply or apply_dct,
    softmax) run op by op -> the full softmax [B, classes]."""
    if wire is None:
        xf = (jnp.asarray(frames).astype(jnp.float32) / 255.0 - 0.5) / 0.5
        logits = jv.apply(pn, cfg, xf)
    else:
        (y, cb, cr), lay = wire
        logits = jv.apply_dct(pn, cfg, jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr),
                              jd.FrameLayout(*lay))
    return np.asarray(jax.nn.softmax(logits, axis=-1))


@pytest.mark.parametrize("k", [1, 5, 10])
def test_service_classify_matches_reference(k):
    """The port's StreamingMedia against the reference service (the tiny
    classifier, bf16), both after load_classifier_params with the carried
    tree: u8 frames (classify_frames) and their coefficients
    (classify_coeffs_dispatch + topk_results). The port is held by the
    tie-tolerant top-k rule at the bf16 bar against the reference service's
    computation run op by op (its full softmax and that softmax's top-k).
    The reference's jitted service differs from its own op-by-op form past
    that bar (1.1-2.2% of a probability over six seeds; ROADMAP queue 3),
    so against the jitted service the port is held by accuracy: with k the
    class count (the whole distribution), its probabilities are as accurate
    against the f32 reference as the jitted service's (mean relative error
    at most 1.25x + 1e-3). The jit gap is printed."""
    cfg = jv.VIT_TINY_TEST
    pn = _params_np(cfg, seed=2)
    f32 = jv.ViTConfig(**{**cfg.__dict__, "dtype": "float32"})
    ref = js.StreamingMedia()
    ref.load_classifier_params(jax.tree_util.tree_map(jnp.asarray, pn), tiny=True)
    port = ts.StreamingMedia(device="cpu")
    port.load_classifier_params(pn, tiny=True)
    frames = _frames(32, 16)
    wire = _wire(frames, 2)
    bar = TOL[cfg.dtype]
    (y, cb, cr), lay = wire
    for got, jitted, src in (
        (port.classify_frames(frames, top_k=k, tiny=True),
         ref.classify_frames_dispatch(frames, top_k=k, tiny=True), dict(frames=frames)),
        (port.topk_results(*port.classify_coeffs_dispatch(y, cb, cr, lay, top_k=k, tiny=True)),
         ref.classify_coeffs_dispatch(y, cb, cr, jd.FrameLayout(*lay), top_k=k, tiny=True),
         dict(wire=wire)),
    ):
        pv = np.array([[p for _, p in r] for r in got])
        iv = np.array([[i for i, _ in r] for r in got])
        assert pv.shape == iv.shape == (16, k)
        full = _op_by_op(pn, cfg, **src)
        want_p, want_i = jax.lax.top_k(jnp.asarray(full), k)
        rec = chip_smoke.topk_agreement(pv, iv, np.asarray(want_p), np.asarray(want_i), full, bar)
        assert rec["ok"], rec
        # against the jitted service: accuracy vs the f32 reference
        jp, ji = (np.asarray(a) for a in jitted)
        exact = _op_by_op(pn, f32, **src)
        err = lambda p, i: float(np.mean(np.abs(  # noqa: E731
            p - np.take_along_axis(exact, i.astype(np.int64), 1)) / p))
        if k == cfg.num_classes:
            assert err(pv, iv) <= 1.25 * err(jp, ji) + 1e-3, (err(pv, iv), err(jp, ji))
        print(f"reference jit vs op-by-op, top-{k}: "
              f"{float(np.max(np.abs(jp - np.take_along_axis(full, ji.astype(np.int64), 1)) / jp))}"
              f" of a probability; ids equal {float(np.mean(ji == iv))}")


def test_classifier_tiny_b16_mismatch_raises_and_streams_work():
    svc = ts.StreamingMedia(device="cpu", generator=torch.Generator().manual_seed(3))
    out = svc.classify_frames(_frames(32, 2), top_k=2, tiny=True)
    assert len(out) == 2 and all(len(r) == 2 for r in out)
    with pytest.raises(ValueError, match="tiny=True"):
        svc.classify_frames(np.zeros((1, 224, 224, 3), np.uint8), tiny=False)
    assert (svc.classifier_flops_per_frame(tiny=True)
            == js.StreamingMedia().classifier_flops_per_frame(tiny=True))
    s = svc.create_stream("asn-1", content_type="video/raw")
    for seq, data in ((2, b"c"), (0, b"a"), (1, b"b")):
        svc.append_chunk(s.stream_id, seq, data)
    assert b"".join(svc.iter_chunks(s.stream_id)) == b"abc" and s.size_bytes == 3
    assert svc.get_chunk(s.stream_id, 1) == b"b" and svc.get_chunk("none", 0) is None
    assert svc.list_streams("asn-1") == [s] and svc.list_streams("other") == []
    with pytest.raises(ValueError, match="exists"):
        svc.create_stream("asn-2", stream_id=s.stream_id)


def test_registry_entry_and_flops():
    spec = tm.get_model("vit_b16")
    assert spec.apply is tv.apply and spec.config_cls is tv.ViTConfig
    for over in ({}, dict(image_size=32, patch_size=8, dim=64, depth=2, heads=2, num_classes=10)):
        want = jc.vit_flops_per_image(jv.ViTConfig(**over))
        assert spec.flops_per_row(tv.ViTConfig(**over)) == want
    assert tv.VIT_B16 == tv.ViTConfig() and tv.VIT_TINY_TEST.num_patches == 16
    assert round(tc.vit_flops_per_image(tv.VIT_B16) / 1e9, 2) == 35.13
    params = spec.init(torch.Generator().manual_seed(0), tv.VIT_TINY_TEST, device="cpu")
    jp = jv.init(jax.random.PRNGKey(0), jv.VIT_TINY_TEST)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    assert tc.tree_map(lambda a: tuple(a.shape), params) == shapes


def test_topk_ties_take_the_lower_index_first():
    """jax.lax.top_k puts the lower index first on ties; the plain top-k
    (a stable descending sort) does the same, and the rule accepts a swap
    of two tied classes and rejects any other id difference."""
    p = np.array([[0.1, 0.3, 0.3, 0.2, 0.3]], np.float32)
    jp, ji = jax.lax.top_k(jnp.asarray(p), 3)
    assert np.asarray(ji).tolist() == [[1, 2, 4]]
    logits = torch.log(torch.from_numpy(p))
    tp, ti = tv.softmax_topk_plain(logits, 3)
    assert ti.tolist() == [[1, 2, 4]] and ti.dtype == torch.int32
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp) / p.sum(), rtol=1e-6)
    full = p / p.sum()
    ok = chip_smoke.topk_agreement(full[:, [1, 4, 2]], [[1, 4, 2]], full[:, [1, 2, 4]],
                                   [[1, 2, 4]], full, 2e-2)
    assert ok["ok"] and ok["ids_equal_share"] == 1 / 3
    bad = chip_smoke.topk_agreement(full[:, [1, 2, 3]], [[1, 2, 3]], full[:, [1, 2, 4]],
                                    [[1, 2, 4]], full, 2e-2)
    assert not bad["ok"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_and_embed_plain_match_reference(dtype):
    """KV's and KT's plain versions against the reference's ops on the
    same inputs: KV bitwise, KT's logits as the reference's ln_f over all
    rows read at [CLS] and its head."""
    jdt, tdt = DTYPES[dtype]
    jcfg, _ = _configs(dtype)
    pn = _params_np(jcfg, seed=5)
    rng = np.random.default_rng(6)
    prod = rng.normal(size=(3, 25, 64)).astype(np.float32)
    pb = jnp.asarray(prod).astype(jdt)
    want = jnp.concatenate([jnp.broadcast_to(jnp.asarray(pn["cls"]).astype(jdt), (3, 1, 64)),
                            pb + jnp.asarray(pn["patch"]["b"]).astype(jdt)], axis=1)
    want = np.asarray((want + jnp.asarray(pn["pos"]).astype(jdt)[None]).astype(jnp.float32))
    got = tv.vit_embed(_t(prod).to(tdt), _t(pn["patch"]["b"]), _t(pn["cls"]), _t(pn["pos"]))
    np.testing.assert_array_equal(got.float().numpy(), want)
    x = (rng.normal(size=(3, 26, 64)) * 2).astype(np.float32)
    xj = jnp.asarray(x).astype(jdt)
    ref = np.asarray(jc.dense(pn["head"], jc.layernorm(pn["ln_f"], xj)[:, 0], jdt)
                     .astype(jnp.float32))
    tp = tc.params_from_numpy(pn, "cpu")
    logits, probs, ids = tv.vit_head(_t(x).to(tdt), tp["ln_f"], tp["head"], 4)
    _close(logits.numpy(), ref, TOL[dtype])
    jprobs, jids = jax.lax.top_k(jax.nn.softmax(jnp.asarray(ref), axis=-1), 4)
    rec = chip_smoke.topk_agreement(probs.numpy(), ids.numpy(), np.asarray(jprobs),
                                    np.asarray(jids), np.asarray(jax.nn.softmax(ref, axis=-1)),
                                    TOL[dtype])
    assert rec["ok"], rec
    assert tv.vit_head(_t(x).to(tdt), tp["ln_f"], tp["head"], 0)[1:] == (None, None)

"""Port parity of the ViT's train form (``sitewhere_tpu_torch.models.vit``:
the plain versions of KT's train mode and KV's backward, the block
composition that walks the blocks' backward kernels, ``loss`` and
``train_step`` with ``ops.adam.adam``) against the JAX package
(``sitewhere_tpu/models/vit.py:121`` ``loss``, ``:127`` ``train_step``), on
the same numpy frames, labels and param tree at ``VIT_TINY_TEST`` (hd 32, T
17).

Bars, each the reference's own or stated here:

- each backward's plain version against ``jax.vjp`` of its reference
  function (ln_f, the head and the log_softmax NLL; the embed epilogue of
  ``vit.py:86-89``): f32 per element at rtol 1e-4 / atol 1e-5; bf16 by
  relative norm at 2e-2 against the reference's f32 vjp;
- the loss: f32 rtol 1e-5; bf16 at the wire bar 2e-2;
- f32 gradients per element at rtol 1e-4 / atol 1e-5
  (``tests/test_train_lane.py:119-124``); bf16 gradients, each leaf within
  2e-2 relative norm of the reference's f32 gradient or 1.25x the
  reference's own bf16 error where that is larger (it is on some leaves at
  this size), printed beside (``attn.wk.b``'s exact gradient is 0: softmax
  ignores a shift of a query's logits, so its bar is scaled by the same
  block's ``attn.wq.b`` gradient);
- params and optax state after 3 ``train_step``s with ``adam(1e-3)``
  against jitted ``optax.adam(1e-3)``: rtol 1e-4, but elements whose
  gradient is at the f32 bar's noise level (|g| <= 1e-5; ``attn.wk.b``'s
  exact 0 among them), which Adam moves by up to lr a step on rounding
  noise: within twice the steps' summed lr; the others also with an atol
  of 1e-3 of the summed lr;
- each injected fault (``chip_smoke.faulted_vit_train_ops``: dlogits
  without log_softmax's term, d pos summed over the positions, the
  attention backward without its Sigma term) fails the bf16 bar.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
import sitewhere_tpu.models.common as jc
import sitewhere_tpu_torch.models as tm
import sitewhere_tpu_torch.models.common as tc
import sitewhere_tpu_torch.models.vit as tv
from sitewhere_tpu.models import vit as jv
from sitewhere_tpu_torch.ops import adam as tadam

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
B = 6

# tiny tensors: one intra-op thread, so the suite's parallel workers keep
# their cores
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _configs(dtype):
    return (dataclasses.replace(jv.VIT_TINY_TEST, dtype=dtype),
            dataclasses.replace(tv.VIT_TINY_TEST, dtype=dtype))


def _params_np(seed=0):
    """A JAX ViT tree as numpy, every 1-D leaf (dense biases, LayerNorm
    scales and biases) moved off its init value by 0.05 N(0, 1), so every
    bias and affine gradient is exercised."""
    rng = np.random.default_rng(seed)
    p = jax.tree_util.tree_map(np.array, jv.init(jax.random.PRNGKey(seed), jv.VIT_TINY_TEST))
    return jax.tree_util.tree_map(
        lambda x: (x + 0.05 * rng.normal(size=x.shape)).astype(np.float32) if x.ndim == 1 else x, p)


def _batch(seed=1, labels=None):
    rng = np.random.default_rng(seed)
    s = jv.VIT_TINY_TEST.image_size
    images = rng.normal(size=(B, s, s, 3)).astype(np.float32)
    if labels is None:
        labels = rng.integers(0, jv.VIT_TINY_TEST.num_classes, B)
    return images, np.asarray(labels, np.int32)


_REF = {}


def _ref_grad(dtype, labels=None):
    """The reference's (loss, grads) as numpy, jitted, cached by dtype and
    labels."""
    key = (dtype, None if labels is None else tuple(labels))
    if key not in _REF:
        jcfg, _ = _configs(dtype)
        images, lab = _batch(labels=labels)
        fn = jax.jit(jax.value_and_grad(lambda p, x, y: jv.loss(p, jcfg, x, y)))
        val, g = fn(jax.tree_util.tree_map(jnp.asarray, _params_np()), images, lab)
        _REF[key] = (float(val), jax.tree_util.tree_map(np.array, g))
    return _REF[key]


def _port_grad(dtype, labels=None, ops=None):
    _, tcfg = _configs(dtype)
    images, lab = _batch(labels=labels)

    def obj(p):
        if ops is None:
            return tm.get_model("vit_b16").loss(p, tcfg, _t(images), _t(lab))
        return tv._train_loss(p, tcfg, _t(images), _t(lab), ops)

    val, g = tc.value_and_grad(obj, tc.params_from_numpy(_params_np(), "cpu"))
    return float(val), tc.params_to_numpy(g)


def _named(tree):
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path), x)
            for path, x in jax.tree_util.tree_leaves_with_path(tree)]


def _rel(got, want, scale=None) -> float:
    den = np.linalg.norm(want) if scale is None else scale
    return float(np.linalg.norm(np.asarray(got, np.float64) - want) / max(den, 1e-30))


def _bf16_errors(got, ref32) -> dict:
    """Each leaf's relative-norm error against the reference's f32 gradient
    (attn.wk.b's against the norm of its block's attn.wq.b gradient)."""
    want = dict(_named(ref32))
    out = {}
    for name, g in _named(got):
        scale = (np.linalg.norm(want[name.replace("wk/b", "wq/b")])
                 if name.endswith("wk/b") else None)
        out[name] = _rel(g, want[name], scale)
    return out


def _close(got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def _bf(a, dtype):
    """numpy f32 values as the compute dtype holds them (bf16-valued for
    bf16), so both packages see the same inputs."""
    return np.asarray(jnp.asarray(a).astype(DTYPES[dtype][0]).astype(jnp.float32))


def _held(dtype, got, ref32, what):
    if dtype == "float32":
        _close(got, ref32)
    else:
        err = _rel(got, ref32)
        assert err <= 2e-2, (what, err)


# -- each backward against jax.vjp of its reference function ---------------------

@pytest.mark.parametrize("labels", [[0, 3, 9, 2, 7, 5], [-1, 3, 10, 2, -10, 5]])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_train_matches_reference(dtype, labels):
    """KT's train mode (the loss, then dh, the head's and ln_f's gradients)
    against the vjp of ln_f on every row, the head on the [CLS] row and the
    log_softmax NLL's mean (``vit.py:92-93``, ``:121-124``); labels -1 and
    -10 wrap, 10 (= C) gives a NaN loss and that frame no gradient."""
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(50)
    cfg = jv.VIT_TINY_TEST
    p = _params_np()
    x = _bf((rng.normal(size=(B, cfg.num_patches + 1, cfg.dim)) * 2 + 0.3).astype(np.float32),
            dtype)
    lab = np.asarray(labels, np.int32)

    def ref(dt):
        def fn(lnf, head, h):
            logits = jc.dense(head, jc.layernorm(lnf, h)[:, 0], dt).astype(jnp.float32)
            logp = jax.nn.log_softmax(logits)
            return -jnp.take_along_axis(logp, jnp.asarray(lab)[:, None], axis=1).mean()

        val, vjp = jax.vjp(fn, p["ln_f"], p["head"], jnp.asarray(x).astype(dt))
        dlnf, dhead, dh = vjp(jnp.float32(1.0))
        return float(val), [np.asarray(a).astype(np.float32) for a in (
            dh, dhead["w"], dhead["b"], dlnf["scale"], dlnf["bias"])]

    val, want = ref(jd)
    tp = tc.params_from_numpy(p, "cpu")
    loss, logits = tv.vit_head_train(_t(x).to(td), tp["ln_f"], tp["head"], _t(lab))
    if 10 in labels:
        assert np.isnan(val) and np.isnan(float(loss))
    else:
        np.testing.assert_allclose(float(loss), val, rtol=1e-5 if dtype == "float32" else 2e-2)
    _, want = ref(jnp.float32)
    args = (_t(x).to(td), tp["ln_f"], tp["head"], _t(lab), logits, torch.tensor(1.0))
    got = tv.vit_head_train_bwd(*args)
    assert got[0].dtype == td and not got[0][:, 1:].any()
    for g, w, what in zip(got, want, ("dh", "dw", "db", "dscale", "dbias")):
        assert np.isfinite(g.float().numpy()).all(), what
        _held(dtype, g.float().numpy(), w, what)
    if 10 in labels:  # the frame past the classes has no gradient
        assert not got[0][2].any() and not want[0][2].any()
    bad = chip_smoke.vit_head_bwd_no_softmax(*args)
    assert max(_rel(g.float().numpy(), w) for g, w in zip(bad, want)) > 2e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_bwd_matches_reference(dtype):
    """KV's backward against the vjp of ``vit.py:86-89`` (the bias add
    after the patch product, the broadcast [CLS] concatenated in front, +
    pos) in the bias, [CLS], the positions and the product."""
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(51)
    cfg = jv.VIT_TINY_TEST
    p = _params_np()
    n, d = cfg.num_patches, cfg.dim
    prod = _bf(rng.normal(size=(B, n, d)).astype(np.float32), dtype)
    dx = _bf(rng.normal(size=(B, n + 1, d)).astype(np.float32), dtype)

    def ref(dt):
        def fn(b, cls, pos, pr):
            x = pr + b.astype(dt)
            c = jnp.broadcast_to(cls.astype(dt), (B, 1, d))
            return jnp.concatenate([c, x], axis=1) + pos.astype(dt)[None]

        _, vjp = jax.vjp(fn, p["patch"]["b"], p["cls"], p["pos"], jnp.asarray(prod).astype(dt))
        return [np.asarray(a).astype(np.float32) for a in vjp(jnp.asarray(dx).astype(dt))]

    want = ref(jnp.float32)
    dpos, dcls, db = tv.vit_embed_bwd(_t(dx).to(td))
    for g, w, what in zip((db, dcls, dpos), want[:3], ("db", "dcls", "dpos")):
        assert g.dtype == torch.float32 and g.shape == w.shape, what
        _held(dtype, g.numpy(), w, what)
    _held(dtype, _t(dx)[:, 1:].numpy(), want[3], "dprod")  # the product's cotangent: dx[:, 1:]
    bad = chip_smoke.vit_embed_bwd_dpos_summed(_t(dx).to(td))[0].numpy()
    assert _rel(bad, want[2]) > 2e-2


# -- the whole loss and its gradients ---------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_reference(dtype):
    val_ref, g_ref = _ref_grad(dtype)
    val, g = _port_grad(dtype)
    np.testing.assert_allclose(val, val_ref, rtol=1e-5 if dtype == "float32" else 2e-2)
    if dtype == "float32":
        for (name, a), (_, b) in zip(_named(g), _named(g_ref)):
            _close(a, b, 1e-4, 1e-5)
        return
    _, g32 = _ref_grad("float32")
    errs = _bf16_errors(g, g32)
    ref_errs = _bf16_errors(g_ref, g32)
    print("bf16 grads vs the reference's f32 (port, reference):",
          {n: (round(errs[n], 5), round(ref_errs[n], 5)) for n in errs})
    # at 6 frames the reference's own bf16 gradient misses 2e-2 on some
    # leaves (up to 3e-2): each leaf is held at 2e-2 or, where the
    # reference's error is larger, 1.25x it (the card's bf16 rule)
    for n in errs:
        assert errs[n] <= max(2e-2, 1.25 * ref_errs[n]), (n, errs[n], ref_errs[n])


def test_labels_wrap_and_past_the_classes_match_reference():
    """Labels -1 (wraps to C - 1) and C (past the classes): the reference's
    loss is NaN, that frame contributes no gradient and the others keep
    their 1/B; the port's gradients match per element."""
    labels = [-1, 10, 2, 5, 0, 9]
    val_ref, g_ref = _ref_grad("float32", labels)
    val, g = _port_grad("float32", labels)
    assert np.isnan(val_ref) and np.isnan(val)
    for (name, a), (_, b) in zip(_named(g), _named(g_ref)):
        assert np.isfinite(a).all(), name
        _close(a, b, 1e-4, 1e-5)


@pytest.mark.parametrize("which", chip_smoke.VIT_TRAIN_FAULTS)
def test_faulted_twins_fail_the_bar(which):
    """Each faulted plain twin's gradient misses the bf16 bar (2e-2 relative
    norm against the reference's f32 gradient) on some leaf."""
    _, g32 = _ref_grad("float32")
    _, g = _port_grad("float32", ops=chip_smoke.faulted_vit_train_ops(which))
    assert max(_bf16_errors(g, g32).values()) > 2e-2


# -- train_step with adam(lr) ---------------------------------------------------------

def test_train_steps_match_optax_adam():
    """3 ``train_step``s through the registry with ``ops.adam.adam(1e-3)``
    against the reference's with jitted ``optax.adam(1e-3)``: the losses,
    params and the optax state (count, mu, nu; its chain's EmptyState)
    carried across as numpy. An element whose gradient is at the f32
    gradient bar's noise level (|g| <= 1e-5, ``attn.wk.b``'s exact 0
    among them) moves by up to lr a step on either side's rounding noise,
    Adam's g / (|g| + eps): it is held within twice the steps' summed lr;
    the others at rtol 1e-4 and an atol of 1e-3 of the summed lr (Adam's
    m / sqrt(v) of a small gradient keeps its last digits' differences:
    the update's direction agrees to 0.1% of its largest move)."""
    jcfg, tcfg = _configs("float32")
    images, lab = _batch()
    jp = jax.tree_util.tree_map(jnp.asarray, _params_np())
    opt = optax.adam(1e-3)
    js = opt.init(jp)
    jstep = jax.jit(lambda p, s, x, y: jv.train_step(p, s, (x, y), jcfg, opt))
    jgrad = jax.jit(jax.grad(lambda p, x, y: jv.loss(p, jcfg, x, y)))
    spec = tm.get_model("vit_b16")
    tp = tc.params_from_numpy(_params_np(), "cpu")
    topt = tadam.adam(1e-3)
    ts = tc.opt_state_from_numpy(jax.tree_util.tree_map(np.array, js), "cpu")
    assert isinstance(ts[0], tadam.AdamState) and ts[1] == tadam.EmptyState()
    noise = None
    for _ in range(3):
        small = [np.abs(np.asarray(g)) <= 1e-5
                 for g in jax.tree_util.tree_leaves(jgrad(jp, images, lab))]
        noise = small if noise is None else [a | b for a, b in zip(noise, small)]
        jp, js, jl = jstep(jp, js, images, lab)
        tp, ts, tl = spec.train_step(tp, ts, (_t(images), _t(lab)), tcfg, topt)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for (name, a), (_, b), m in zip(_named(tc.params_to_numpy(tp)),
                                    _named(jax.tree_util.tree_map(np.array, jp)), noise):
        assert float(np.abs(a - b)[m].max(initial=0.0)) <= 2 * 3 * 1e-3, name
        _close(a[~m], b[~m], 1e-4, 1e-3 * 3 * 1e-3)
    state = tc.opt_state_to_numpy(ts)
    assert int(state[0].count) == int(js[0].count) == 3 and state[1] == tadam.EmptyState()
    # the moments at the f32 gradient bar: mu a mean of gradients, nu of
    # their squares (twice the relative error)
    for a, b in zip(jax.tree_util.tree_leaves(state[0].mu), jax.tree_util.tree_leaves(js[0].mu)):
        _close(a, np.asarray(b), 1e-4, 1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(state[0].nu), jax.tree_util.tree_leaves(js[0].nu)):
        _close(a, np.asarray(b), 2e-4, 1e-10)


def test_apply_step_keeps_the_optax_surface_for_other_optimizers():
    """``apply_step`` takes an optimizer that is not the port's through its
    own ``update`` (then p + u) on any device."""

    class Sgd:
        def update(self, grads, state, params=None):
            return tc.tree_map(lambda g: -0.5 * g, grads), state + 1

    params = {"w": torch.ones(3), "b": torch.zeros(2)}
    grads = {"w": torch.full((3,), 2.0), "b": torch.ones(2)}
    p2, s2 = tadam.apply_step(Sgd(), params, grads, 0)
    assert s2 == 1 and torch.equal(p2["w"], torch.zeros(3)) and torch.equal(p2["b"], -0.5 * torch.ones(2))


def test_registry_entry():
    spec = tm.get_model("vit_b16")
    assert spec.loss is tv.loss and spec.train_step is tv.train_step
    assert spec.apply is tv.apply and spec.config_cls is tv.ViTConfig


# -- the repairs ---------------------------------------------------------------------

def test_attention_caps_follow_the_kernels_shared_memory():
    """The staged KA's T cap by direction, dtype and head dim, from the
    kernels' own shared-memory formulas: ViT-B/16's T 197 stays with the
    staged f32 hd-64 backward; T 210 goes to the tiled backward, decided
    before any launch, and the tiled form computes it (on CPU tensors, the
    plain version)."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert tc.attn_max_t(False, f32, 64) == 435 and tc.attn_max_t(True, f32, 64) == 209
    assert tc.attn_max_t(True, bf16, 64) == 416 and tc.attn_max_t(True, f32, 32) == 393
    assert tc.attn_max_t(False, bf16, 64) == tc.attn_max_t(True, bf16, 32) == 512
    assert tc.attn_smem_bytes(True, f32, 64, 197) == 218748
    q = torch.zeros((1, 197, 768))
    assert tc._check_attention("KA's backward", q, q, q, 12) == 64
    assert tc.attn_route(True, f32, 64, 197) == "staged"
    q = torch.zeros((1, 210, 768))
    assert tc._check_attention("KA", q, q, q, 12) == 64
    assert tc.attn_route(False, f32, 64, 210) == "staged"
    assert tc.attn_route(True, f32, 64, 210) == "tiled"
    grads = tc.attention_tiled_bwd(q, q, q, q + 1, 12, False)
    assert all(g.shape == q.shape for g in grads)


@pytest.mark.parametrize("family", ["lstm_ad", "deepar"])
def test_per_tenant_loss_on_one_slot_is_the_composition(family):
    """The per-tenant ``loss`` on CUDA tensors is ``loss_stacked`` over one
    slot (KB or KR), the mean of its per-row means: on the CPU (the plain
    versions) that form equals the per-tenant composition at the f32 bar."""
    spec = tm.get_model(family)
    cfg = tm.make_config(family, {"hidden": 16, "window": 12, "context": 12, "dtype": "float32"})
    params = spec.init(torch.Generator().manual_seed(3), cfg, device="cpu")
    rng = np.random.default_rng(4)
    windows = _t(np.cumsum(rng.normal(size=(24, 12)), -1).astype(np.float32))
    one = spec.loss_stacked(tc.tree_map(lambda x: x[None], params), cfg, windows[None])[0].mean()
    np.testing.assert_allclose(float(one), float(spec.loss(params, cfg, windows)), rtol=1e-5)

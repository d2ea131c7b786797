"""Outputs of the port's paths that must stay bitwise from one tree to
another, on one card: the transformer32 flush, ``score_stacked`` and the
forecast on f32 master weights (KE, KL, the staged KA, KU, KN), the
transformer's train loss and gradients on two slots, the staged KA forward
and backward at the transformer's and ViT-B/16's shapes, the ViT-B/16
forward, and the recurrent families at the shapes their templated kernels
take: KW's one-block form on tenants32's flush, KS and KD (hidden 64,
window 32; f32 masters and LSTM-AD's int8 tree) in both modes, KF at
``deepar_replay``'s shape, and KB and KR (the loss and every gradient leaf
at hidden 64 / window 32 in bf16 and f32 compute and at hidden 16 / window
16, ring and windows mode); the tiled KA at hd 80, 256 and T 577, KE's
context mode on a raw history of 4,096 values (the forecast) and KT's top-64
in bf16 and f32; the wide forms of KS, KD (f32 and int8), KF, KB and KR at
main path m's shapes (LSTM-AD hidden 128 / window 256, DeepAR 40 / 192),
which keep their form beside the global one; the blocks' composition
(``blocks_stacked``, whose ``_block`` takes the tensor-parallel block's
reduce hook) for the transformer and ViT-B/16 in bf16 and f32 and the
ViT's f32 forward. The tiled KA's bf16 instance runs on tensor cores (its
first form ran on CUDA cores), so its 12 outputs (``ka_tiled_hd80``, ``ka_tiled_hd256``,
``ka_tiled_t577`` and their ``ka_bwd_tiled_*_dq/dk/dv``) move from the
parent's bits (the accumulation order of every product changed; the
rounding points did not); its f32 instance at the same shapes
(``ka_tiled_*_f32``, ``ka_bwd_tiled_*_f32_*``) stays bitwise, and the file
keeps float64 references (``f64:`` keys, not compared) from which
``compare`` reports each differing output's accuracy in both trees. Likewise
the split KA (hd 512 at T 31 causal, main path p's head; hd 300 at T 197):
its bf16 instance moved to tensor cores, so its 8 outputs (``ka_split_*``,
``ka_bwd_split_*``) move from a CUDA-core parent's bits, while its f32
instance (``ka_split_*_f32``, ``ka_bwd_split_*_f32_*``) stays bitwise. Likewise
the staged KA's bf16 instance (on tensor cores since its third redesign):
its outputs at the transformer's and ViT-B/16's shapes (``ka_tf``,
``ka_vit``, ``ka_bwd_tf_*``, ``ka_bwd_vit_*``) and every bf16 path that runs
it (the transformer32 flush, ``score_stacked`` and forecasts, the train
loss and gradients, the ViT forward, the bf16 blocks) move, the KA outputs
with float64 references; its f32 instance (``ka_tf_f32``, ``ka_vit_f32``,
``ka_bwd_*_f32_*``) and the f32 paths stay bitwise. Run it by path once per
tree, the tree's package first on ``PYTHONPATH``, then compare the two
files:

    PYTHONPATH=<parent tree> python sitewhere_tpu_torch/tree_parity.py save a.pt
    PYTHONPATH=. python sitewhere_tpu_torch/tree_parity.py save b.pt
    python sitewhere_tpu_torch/tree_parity.py compare a.pt b.pt

It uses only entry points that both trees have; it exits 1 when any output
differs, printing each one's max abs difference, its relative norm
difference and its mean abs error against float64 in either tree.
``tree_parity.py time`` prints the times of the staged KA's paths
(``timings``) with the tree's package: run it on two trees in turns in one
call to compare them. Nothing runs at import.
"""
import sys

import torch


def outputs():
    from sitewhere_tpu_torch import kernels
    from sitewhere_tpu_torch.models import common as tc
    from sitewhere_tpu_torch.models import get_model, make_config
    from sitewhere_tpu_torch.models import transformer as tt
    from sitewhere_tpu_torch.models import vit as tv
    from sitewhere_tpu_torch.ops.windows import WindowState, window_update

    dev = torch.device("cuda")
    out = {}
    gen = torch.Generator(device=dev).manual_seed(5)
    # transformer32's flush on f32 masters (KW, KE, KL, staged KA, KU, KN)
    cfg = make_config("transformer", {})
    spec = get_model("transformer")
    g = torch.Generator().manual_seed(9)
    params = tc.tree_map(lambda *xs: torch.stack(xs),
                         *[spec.init(g, cfg, device=dev) for _ in range(32)])
    tc.tree_map(lambda x: x.add_(0.05 * torch.randn(x.shape, generator=g).to(dev))
                if x.ndim == 2 else x, params)
    t, b, s, w = 32, 2048, 8192, 32
    st = WindowState(torch.randn((t, s, w), generator=gen, device=dev),
                     torch.randint(0, w, (t, s), generator=gen, device=dev, dtype=torch.int32),
                     torch.randint(0, 2 * w, (t, s), generator=gen, device=dev, dtype=torch.int32))
    ids = torch.randint(0, s, (t, b), generator=gen, device=dev, dtype=torch.int32)
    vals = torch.randn((t, b), generator=gen, device=dev)
    counts = torch.full((t, 1), b, dtype=torch.int32, device=dev)
    active = torch.ones((t,), dtype=torch.bool, device=dev)
    later = window_update(st, ids, vals, counts=counts)
    for name, x in zip(("values", "pos", "count", "later"), (*st, later)):
        out[f"kw_{name}"] = x.clone()
    # the recurrent flushes at their templated kernels' shapes (KS, KD)
    for fam in ("lstm_ad", "deepar"):
        rspec, rcfg = get_model(fam), make_config(fam, {})
        rp = tc.tree_map(lambda *xs: torch.stack(xs),
                         *[rspec.init(g, rcfg, device=dev) for _ in range(t)])
        trees = {"f32": rp, "int8": tc.quantize_params(rp, "int8")} if fam == "lstm_ad" \
            else {"f32": rp}
        for fmt, tree in trees.items():
            out[f"{fam}_{fmt}_flush"] = rspec.score_flush(tree, rcfg, st, ids, later, active,
                                                          counts=counts)
        out[f"{fam}_windows_k3"] = rspec.score_stacked(
            rp, rcfg, st.values[:, :512], torch.full((t, 512), w, dtype=torch.int32,
                                                      device=dev), k=3)
        if fam == "deepar":  # KF at deepar_replay's shape: 64 paths, context 128
            one_r = tc.tree_map(lambda x: x[0], rp)
            fc = rspec.forecast(one_r, rcfg, st.values[0, :128, :].repeat(1, 4).contiguous(),
                                eps=torch.randn((rcfg.horizon, rcfg.num_samples * 128),
                                                generator=gen, device=dev))
            out["deepar_forecast_samples"], out["deepar_forecast_mean"] = fc
    # the templated train forms (KB, KR) at shapes they took: the loss and
    # every gradient leaf of the masked per-slot mean, ring and windows mode
    from sitewhere_tpu_torch.models.train import ring_windows

    for fam in ("lstm_ad", "deepar"):
        rspec = get_model(fam)
        for hid, tw_, dtype in ((64, 32, "bfloat16"), (64, 32, "float32"),
                                (16, 16, "bfloat16")):
            rcfg = make_config(fam, {"hidden": hid, "window": tw_, "dtype": dtype})
            rp = tc.tree_map(lambda *xs: torch.stack(xs),
                             *[rspec.init(g, rcfg, device=dev) for _ in range(4)])
            ring = WindowState(
                torch.randn((4, 1024, tw_), generator=gen, device=dev).cumsum(-1),
                torch.randint(0, tw_, (4, 1024), generator=gen, device=dev, dtype=torch.int32),
                torch.randint(0, 2 * tw_, (4, 1024), generator=gen, device=dev,
                              dtype=torch.int32))
            rows = (ring.count.clamp(max=tw_) >= 8).float()
            rows[2] = 0.0
            wins = ring_windows(ring)
            for mode, loss in (("ring", lambda p: rspec.loss_ring(p, rcfg, ring)),
                               ("windows", lambda p: rspec.loss_stacked(p, rcfg, wins))):
                kept = {}

                def obj(p):
                    kept["per_row"] = loss(p)
                    return ((kept["per_row"] * rows).sum(-1)
                            / torch.clamp_min(rows.sum(-1), 1.0)).sum()

                _, grads = tc.value_and_grad(obj, rp)
                key = f"{fam}_train_h{hid}_w{tw_}_{dtype}_{mode}"
                out[f"{key}_loss"] = kept["per_row"].detach()
                for i, gl in enumerate(tc.tree_leaves(grads)):
                    out[f"{key}_grad_{i}"] = gl
    kernels.reset_launches()
    out["tf_flush"] = tt.tf_score(params, cfg, st, ids, later, active, counts=counts)
    out["tf_score_stacked_k3"] = tt.score_stacked(params, cfg, st.values[:, :512], torch.full(
        (t, 512), w, dtype=torch.int32, device=dev), k=3)
    one = tc.tree_map(lambda x: x[0], params)
    out["tf_forecast"] = torch.stack(tt.forecast(one, make_config("transformer", {}),
                                                 st.values[0, :64].contiguous(),
                                                 eps=torch.randn((24, 64), generator=gen,
                                                                 device=dev)))
    # the train form's loss and gradients on two slots (KE, KN train modes)
    two = tc.tree_map(lambda x: x[:2], params)
    val, grads = tc.value_and_grad(
        lambda p: tt.loss_stacked(p, cfg, st.values[:2, :1024]).mean(), two)
    out["tf_loss"] = val
    for i, gl in enumerate(tc.tree_leaves(grads)):
        out[f"tf_grad_{i}"] = gl
    # staged KA at the shapes it took: transformer32's and ViT-B/16's
    for tag, (n, tt_, h, hd, causal) in {"tf": (4096, 31, 4, 32, True),
                                          "vit": (64, 197, 12, 64, False)}.items():
        q, k, v, do = (torch.randn((n, tt_, h * hd), generator=gen, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        out[f"ka_{tag}"] = tc.attention(q, k, v, h, causal)
        for nm, x in zip(("dq", "dk", "dv"), tc.attention_bwd(q, k, v, do, h, causal)):
            out[f"ka_bwd_{tag}_{nm}"] = x
        _f64_and_f32(out, tag, q, k, v, do, h, causal)
    # the ViT-B/16 forward (KP, KV, blocks, KT)
    vg = torch.Generator().manual_seed(3)
    vp = tv.init(vg, tv.VIT_B16, device=dev)
    frames = torch.randint(0, 256, (8, 224, 224, 3), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.uint8)
    for i, x in enumerate(tv.classify(vp, tv.VIT_B16, frames, 5)):
        out[f"vit_{i}"] = x
    # the shapes the older forms took beside the newer ones: the tiled KA
    # (hd 80, hd 256, T 577), KE's context mode on the longest raw history
    # it took (4,096 values), KT's argmax rounds at top-64 in both dtypes
    for tag, (n, tt_, h, hd, causal) in {"tiled_hd80": (16, 257, 4, 80, False),
                                          "tiled_hd256": (8, 33, 1, 256, True),
                                          "tiled_t577": (8, 577, 2, 64, False)}.items():
        q, k, v, do = (torch.randn((n, tt_, h * hd), generator=gen, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        out[f"ka_{tag}"] = tc.attention(q, k, v, h, causal)
        for nm, x in zip(("dq", "dk", "dv"), tc.attention_bwd(q, k, v, do, h, causal)):
            out[f"ka_bwd_{tag}_{nm}"] = x
        _f64_and_f32(out, tag, q, k, v, do, h, causal)
    raw = torch.randn((8, 4096), generator=gen, device=dev).cumsum(-1)
    out["tf_forecast_raw4096"] = torch.stack(tt.forecast(
        one, make_config("transformer", {}), raw,
        eps=torch.randn((24, 8), generator=gen, device=dev)))
    for dt in (torch.bfloat16, torch.float32):
        x = torch.randn((64, 197, 768), generator=gen, device=dev).to(dt)
        for i, y in enumerate(tv.vit_head(x, vp["ln_f"], vp["head"], 64)):
            out[f"kt_top64_{str(dt)[6:]}_{i}"] = y
    # the wide forms at main path m's shapes, which they keep beside the
    # global form: LSTM-AD at hidden 128 / window 256 and DeepAR at 40 / 192
    # (KS, KD: the flush form on f32 masters and int8, windows mode; KB, KR:
    # the loss and gradients in ring mode), KF at hidden 40 with 256 paths
    for fam, hid, ww in (("lstm_ad", 128, 256), ("deepar", 40, 192)):
        rspec = get_model(fam)
        rcfg = make_config(fam, {"hidden": hid, "window": ww})
        rp = tc.tree_map(lambda *xs: torch.stack(xs),
                         *[rspec.init(g, rcfg, device=dev) for _ in range(4)])
        ring = WindowState(
            torch.randn((4, 1024, ww), generator=gen, device=dev).cumsum(-1),
            torch.randint(0, ww, (4, 1024), generator=gen, device=dev, dtype=torch.int32),
            torch.randint(0, 2 * ww, (4, 1024), generator=gen, device=dev, dtype=torch.int32))
        wids = torch.randint(0, 1024, (4, 512), generator=gen, device=dev, dtype=torch.int32)
        wvals = torch.randn((4, 512), generator=gen, device=dev)
        wcounts = torch.full((4, 1), 512, dtype=torch.int32, device=dev)
        wlater = window_update(ring, wids, wvals, counts=wcounts)
        for fmt in ("f32", "int8"):
            tree = tc.quantize_params(rp, fmt)
            out[f"{fam}_wide_h{hid}_{fmt}_flush"] = rspec.score_flush(
                tree, rcfg, ring, wids, wlater, active[:4], counts=wcounts)
        out[f"{fam}_wide_h{hid}_windows_k2"] = rspec.score_stacked(
            rp, rcfg, ring.values[:, :256], ring.count[:, :256].clamp(max=ww), k=2)
        rows = (ring.count.clamp(max=ww) >= 8).float()
        kept = {}

        def wobj(p):
            kept["per_row"] = rspec.loss_ring(p, rcfg, ring)
            return ((kept["per_row"] * rows).sum(-1) / torch.clamp_min(rows.sum(-1), 1.0)).sum()

        _, grads = tc.value_and_grad(wobj, rp)
        out[f"{fam}_wide_train_h{hid}_loss"] = kept["per_row"].detach()
        for i, gl in enumerate(tc.tree_leaves(grads)):
            out[f"{fam}_wide_train_h{hid}_grad_{i}"] = gl
    kcfg = make_config("deepar", {"context": 168, "hidden": 40, "num_samples": 256})
    kp = get_model("deepar").init(g, kcfg, device=dev)
    kwins = torch.randn((16, 168), generator=gen, device=dev).cumsum(-1)
    out["deepar_wide_forecast_h40_s256"] = torch.cat([x.flatten() for x in get_model(
        "deepar").forecast(kp, kcfg, kwins, eps=torch.randn((24, 256 * 16), generator=gen,
                                                            device=dev))])
    # the blocks' composition (models.common._block) on one device, whose
    # wo and fc2 products pass the tensor-parallel block's reduce hook: the
    # transformer's causal blocks on 4 slots and ViT-B/16's first two
    # non-causal ones on one, in bf16 and f32 compute, and the ViT's f32
    # forward
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt)[6:]
        four = tc.tree_map(lambda x: x[:4], params["blocks"])
        x = torch.randn((4, 64, 31, 128), generator=gen, device=dev).to(dt)
        out[f"tf_blocks_{name}"] = tc.blocks_stacked(four, x, 4, True, dt, tt.KERNEL_OPS)
        vb = [tc.tree_map(lambda a: a[None], blk) for blk in vp["blocks"][:2]]
        x = torch.randn((1, 8, 197, 768), generator=gen, device=dev).to(dt)
        out[f"vit_blocks_{name}"] = tc.blocks_stacked(vb, x, 12, False, dt, tv.KERNEL_OPS)
    vcfg32 = tv.ViTConfig(dtype="float32")
    for i, x in enumerate(tv.classify(vp, vcfg32, frames, 5)):
        out[f"vit_f32_{i}"] = x
    # the split KA at main path p's head (hd 512, T 31, causal) and at hd
    # 300 over ViT-B/16's T 197, with float64 references and the f32
    # instance (a generator of its own: the draws above stay as they were)
    sgen = torch.Generator(device=dev).manual_seed(16)
    for tag, (n, tt_, h, hd, causal) in {"split_hd512_t31": (64, 31, 1, 512, True),
                                          "split_hd300_t197": (8, 197, 1, 300, False)}.items():
        q, k, v, do = (torch.randn((n, tt_, h * hd), generator=sgen, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        out[f"ka_{tag}"] = tc.attention(q, k, v, h, causal)
        for nm, x in zip(("dq", "dk", "dv"), tc.attention_bwd(q, k, v, do, h, causal)):
            out[f"ka_bwd_{tag}_{nm}"] = x
        _f64_and_f32(out, tag, q, k, v, do, h, causal)
    torch.cuda.synchronize()
    return {k: v.cpu() for k, v in out.items()}


def _f64_and_f32(out, tag, q, k, v, do, h, causal):
    """KA's float64 references (``f64:`` keys, not compared) and its f32
    instance on the same bf16 inputs, widened."""
    from sitewhere_tpu_torch.models import common as tc

    w = [x.double() for x in (q, k, v, do)]
    out[f"f64:ka_{tag}"] = tc.attention_plain(*w[:3], h, causal)
    for nm, x in zip(("dq", "dk", "dv"), tc.attention_bwd_plain(*w, h, causal)):
        out[f"f64:ka_bwd_{tag}_{nm}"] = x
    f = [x.float() for x in (q, k, v, do)]
    out[f"ka_{tag}_f32"] = tc.attention(*f[:3], h, causal)
    for nm, x in zip(("dq", "dk", "dv"), tc.attention_bwd(*f, h, causal)):
        out[f"ka_bwd_{tag}_f32_{nm}"] = x


def _ms(fn, iters: int, warmup: int = 1) -> list:
    """Each of ``iters`` calls' CUDA-event milliseconds, after ``warmup``."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return times


def _device_ms(fn) -> list:
    """``fn``'s device time under torch.profiler (one warm call): [all
    kernels' ms, KA's kernels' ms] ([] if the profiler sees no device
    time)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = ka = 0.0
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue  # host ops: their device time is their kernels'
        us = getattr(e, "self_device_time_total", None)
        ms = (getattr(e, "self_cuda_time_total", 0) if us is None else us) / 1e3
        total += ms
        ka += ms if "attention" in e.key else 0.0
    return [total, ka] if total > 0 else []


def timings():
    """CUDA-event times (ms, each call) of the paths KA's staged form runs,
    through entry points both trees have: the transformer32 flush
    (``tf_score``, 32 slots x 2,048 rows), its train step's gradients over
    the full plane (32 x 8,192 streams, window 32, ``loss_ring`` a chunk of
    slots at a time as the scorer chunks it), the forecast at 128 windows
    of context 128 (K11; also its device time, all kernels' and KA's, under
    torch.profiler), the ViT-B/16 forward on 64 frames (``classify``,
    top-5) and its train step (Adam), and the staged KA alone at
    transformer32's, ViT-B/16-224's and the forecast's shapes."""
    from sitewhere_tpu_torch.models import common as tc
    from sitewhere_tpu_torch.models import get_model, make_config
    from sitewhere_tpu_torch.models import transformer as tt
    from sitewhere_tpu_torch.models import vit as tv
    from sitewhere_tpu_torch.ops import adam
    from sitewhere_tpu_torch.ops.windows import WindowState, window_update
    from sitewhere_tpu_torch.parallel.sharded import ShardedScorer

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    g = torch.Generator().manual_seed(9)
    res = {}
    cfg, spec = make_config("transformer", {}), get_model("transformer")
    params = tc.tree_map(lambda *xs: torch.stack(xs),
                         *[spec.init(g, cfg, device=dev) for _ in range(32)])
    t, b, s, w = 32, 2048, 8192, 32
    st = WindowState(torch.randn((t, s, w), generator=gen, device=dev).cumsum(-1),
                     torch.randint(0, w, (t, s), generator=gen, device=dev, dtype=torch.int32),
                     torch.randint(0, 2 * w, (t, s), generator=gen, device=dev, dtype=torch.int32))
    ids = torch.randint(0, s, (t, b), generator=gen, device=dev, dtype=torch.int32)
    counts = torch.full((t, 1), b, dtype=torch.int32, device=dev)
    active = torch.ones((t,), dtype=torch.bool, device=dev)
    later = window_update(st, ids, torch.randn((t, b), generator=gen, device=dev), counts=counts)
    res["transformer32_flush"] = _ms(
        lambda: tt.tf_score(params, cfg, st, ids, later, active, counts=counts), 5)
    rows = (st.count.clamp(max=w) >= 8).float()
    chunk = max(1, min(t, ShardedScorer.TRAIN_SAVE_BYTES // (s * tt.train_bytes_per_row(cfg, w))))

    def train_grads():
        for lo in range(0, t, chunk):
            sl = slice(lo, min(lo + chunk, t))
            ring = WindowState(*(x[sl] for x in st))
            tc.value_and_grad(lambda p: ((spec.loss_ring(p, cfg, ring) * rows[sl]).sum(-1)
                                         / rows[sl].sum(-1).clamp_min(1.0)).sum(),
                              tc.tree_map(lambda x: x[sl], params))

    res["transformer32_train_step_grads"] = _ms(train_grads, 2)
    del params
    torch.cuda.empty_cache()
    fcfg = make_config("transformer", {"context": 128})
    fp = spec.init(g, fcfg, device=dev)
    wins = torch.randn((128, 128), generator=gen, device=dev).cumsum(-1)

    def forecast():
        spec.forecast(fp, fcfg, wins,
                      eps=torch.randn((fcfg.horizon, 128), generator=gen, device=dev))

    res["forecast_k11"] = _ms(forecast, 5)
    res["forecast_k11_device"] = _device_ms(forecast)
    vp = tv.init(torch.Generator().manual_seed(3), tv.VIT_B16, device=dev)
    frames = torch.randint(0, 256, (64, 224, 224, 3), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.uint8)
    res["vit_forward_64"] = _ms(lambda: tv.classify(vp, tv.VIT_B16, frames, 5), 5)
    vspec, opt = get_model("vit_b16"), adam.adam(1e-3)
    images = torch.rand((64, 224, 224, 3), generator=gen, device=dev)
    labels = torch.randint(0, tv.VIT_B16.num_classes, (64,), generator=gen, device=dev)
    box = {"p": tc.tree_map(torch.clone, vp)}
    box["s"] = opt.init(box["p"])

    def vit_step():
        box["p"], box["s"], _ = vspec.train_step(box["p"], box["s"], (images, labels),
                                                 tv.VIT_B16, opt)

    res["vit_train_step"] = _ms(vit_step, 3)
    del box, vp
    torch.cuda.empty_cache()
    for tag, (n, tt_, h, hd, causal) in {"ka_transformer32": (65536, 31, 4, 32, True),
                                          "ka_vit224": (64, 197, 12, 64, False),
                                          "ka_k11_t128": (128, 128, 4, 32, True)}.items():
        q, k, v, do = (torch.randn((n, tt_, h * hd), generator=gen, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        res[tag] = _ms(lambda: tc.attention(q, k, v, h, causal), 10)
        res[f"{tag}_bwd"] = _ms(lambda: tc.attention_bwd(q, k, v, do, h, causal), 10)
    return res


def main(argv) -> int:
    if argv[0] == "save":
        torch.save(outputs(), argv[1])
        return 0
    if argv[0] == "time":
        import json

        print(json.dumps({"timings_ms": timings()}))
        return 0
    a, b = torch.load(argv[1]), torch.load(argv[2])
    keys = [k for k in a if not k.startswith("f64:")]
    bad = [k for k in keys if not torch.equal(a[k], b[k])]
    detail = {}
    for k in bad:
        x, y = a[k].double(), b[k].double()
        d = {"max_abs_diff": float((x - y).abs().max()),
             "rel_norm_diff": float((x - y).norm() / y.norm().clamp_min(1e-30))}
        if f"f64:{k}" in a:
            d["mean_abs_err_vs_f64"] = [float((z[k].double() - z[f"f64:{k}"]).abs().mean())
                                        for z in (a, b)]
        detail[k] = d
    print({"compared": len(keys), "differ": bad, "detail": detail})
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""sitewhere_tpu_torch — the PyTorch/CUDA port of ``sitewhere_tpu``.

The port is a package of its own beside the JAX package, which stays the
reference every ported part is held against. It imports ``torch`` and
numpy, never ``jax`` and nothing of ``sitewhere_tpu``: what it needs from
there it keeps as its own copy.

Layout mirrors the JAX package so each counterpart is easy to find:

  ops/windows.py       per-stream ring-buffer windows (kernel KW)
  ops/dct.py           the compressed media wire's decode (kernel KJ)
  models/common.py     shared model helpers, the transformer block's kernels
                       (KL, KA, KU) and its one composition, FLOP accounting
  ops/adam.py          Adam: the train lane's per-slot step and the
                       per-tenant train steps' (kernel KO)
  models/flush.py      the flush form shared by the scan scorers' kernels
  models/train.py      the train form shared by the BPTT kernels
  models/lstm_ad.py    the LSTM anomaly detector: scoring (kernel KS) and
                       its train form (kernel KB)
  models/deepar.py     the DeepAR forecaster: NLL scoring (kernel KD),
                       sampled forecasts (kernel KF), its train form (KR)
  models/transformer.py  the transformer forecaster (kernels KE, KN)
  models/vit.py        the ViT-B/16 frame classifier (kernels KP, KV, KT)
                       and its training (KT's train mode, KV's backward)
  models/__init__.py   the model registry (``lstm_ad``, ``deepar``,
                       ``transformer``, ``vit_b16``)
  parallel/mesh.py     the one-device MeshManager
  parallel/dist.py     ranks over torch.distributed: the mesh axis of the
                       multi-device paths (ring attention, the
                       sequence-parallel backbone, tensor-parallel ViT)
  ops/ring_attention.py  ring attention (kernel KA ring step)
  ops/pipeline_parallel.py  GPipe over ranks
  parallel/sharded.py  ShardedScorer, the stacked multi-tenant scoring
                       flush (kernels KH and KG) and the train lane
  pipeline/inference.py  stream registry, lane rings, staging sets
  services/streaming_media.py  media streams and frame classification
  core/model.py, sim/media.py  tokens; the synthetic camera frames
  kernels.py           builds csrc/*.cu with nvcc and binds them (ctypes)

Entry points default to ``device="cuda"`` and raise when no card is
present; pass ``device="cpu"`` to run the plain PyTorch versions of the
kernels (what the tests do).
"""

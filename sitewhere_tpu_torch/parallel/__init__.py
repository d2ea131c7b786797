"""One-device mesh, the stacked multi-tenant scorer, and ranks over
``torch.distributed`` for the multi-device paths."""

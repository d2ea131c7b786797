"""One-device mesh and the stacked multi-tenant scorer."""

"""Graph IR, features, the GraphSAGE cost model and batched inference."""

"""Building blocks of the cost model: dense, embedding, norms, MLP, encoder."""

"""The trained models at inference: the cross-encoder reranker and the
bi-encoder embedder, with the JAX package's weight files."""

"""The port's tools: the checks and measurements that run on a CUDA card, and
the user tools, each the twin of the JAX package's tool of its name."""

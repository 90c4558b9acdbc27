"""A multi-agent reinforcement learning framework in JAX.

Capability surface of InstaDeep's Mava (ff/rec IPPO & MAPPO, rec-IQL, ff-ISAC/MASAC;
masked discrete + tanh continuous actions; CTDE/DTDE; evaluator + absolute metric;
marl-eval JSON logging; optional orbax checkpoints) rebuilt from scratch:

  * mesh/`shard_map` SPMD runtime instead of pmap (gradients all-reduced over the
    device mesh);
  * JAX-native environment suite (RWARE, LBF, SMAX, Matrax, Cleaner, Connector, ...)
    shipped in-tree — fully static-shape, vmap/scan-friendly;
  * own replay buffers, distributions, config system — zero heavyweight deps.
"""

__version__ = "0.1.0"

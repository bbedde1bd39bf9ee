"""The benchmark of ``quiver_tpu_torch`` on one NVIDIA H100: the full-graph
layer-wise GraphSAGE pass over a products-shaped graph.
``python -m perfbench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>``; see ``perfbench/README.md``."""

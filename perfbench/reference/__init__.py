"""The plain reference: GraphSAGE's full-graph pass, in plain PyTorch.

It imports nothing of the program (``quiver_tpu_torch``), nor JAX, nor the
JAX package, and takes nothing the program made: it works out the graph
and the model again from the benchmark's own inputs (``perfbench.data``). It reads the program's outputs only to judge them.
"""

"""The yardstick: generators, the plain reference, peaks and bounds.

Plain numpy and PyTorch only: nothing here imports the measured program
(`dgraph_tpu_torch`), JAX or the JAX package.
"""

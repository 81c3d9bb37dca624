"""CLEAN minor cycles of the port (Hogbom, Clark): counterparts of
pfb_tpu/deconv/, the JAX while loops written as Python loops of tensor
operations with the same stopping rules."""

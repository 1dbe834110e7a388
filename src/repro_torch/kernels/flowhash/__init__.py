"""murmur3 flow hash: the port of the JAX package's two Pallas flow-hash
kernels, as one CUDA kernel (``csrc/flowhash.cu``)."""

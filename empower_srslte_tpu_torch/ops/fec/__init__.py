"""Forward error correction: turbo and convolutional codecs, rate
matching, and the two hand-written CUDA kernels' wrappers."""

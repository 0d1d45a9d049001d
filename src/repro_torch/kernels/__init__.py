"""Hand-written CUDA kernels (`csrc/`), their nvcc build (`build`), plain
PyTorch versions (`ref`) and the wrappers that pick between them (`ops`)."""

def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device and nvcc (s2d_tpu_torch kernels); skipped "
        "where torch.cuda.is_available() is false",
    )

def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card and nvcc (skips itself where torch.cuda.is_available() is False)",
    )

from repro_torch.serving.server import BatchedServer, Request  # noqa: F401

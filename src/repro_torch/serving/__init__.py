"""LM serving of the port (the reference's ``repro.serving``)."""
from repro_torch.serving.server import BatchingServer, Request, ServerConfig

__all__ = ["BatchingServer", "Request", "ServerConfig"]

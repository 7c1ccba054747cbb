"""Serving-side helpers of the port: trace payloads and the load generator."""
from repro_torch.serve.client import LoadGenerator, LoadResult, attach_payloads

__all__ = ["LoadGenerator", "LoadResult", "attach_payloads"]

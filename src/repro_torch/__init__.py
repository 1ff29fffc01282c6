"""PyTorch + CUDA port of the DSI pipeline (reference: ``repro``)."""

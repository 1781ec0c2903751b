"""Batched serving: prefill → decode, KV migration, the captured decode
step."""

from repro_torch.serving.engine import (  # noqa: F401
    Request, ServeEngine, make_captured_decode_step, make_serve_step)

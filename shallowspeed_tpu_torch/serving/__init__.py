"""Serving for the port: slot geometry, the engine, load generation and the
``python -m shallowspeed_tpu_torch.serving`` entry point."""

"""Runnable examples of the port (``python -m pyrenderer_tpu_torch.examples.NAME``)."""

"""Entry points: ``serve_dfr`` — the continuous-batching online DFR server
and its CLI (``python -m repro_torch.launch.serve_dfr``)."""

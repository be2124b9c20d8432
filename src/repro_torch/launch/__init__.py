"""Entry points: ``serve_dfr`` — the continuous-batching online DFR server
and its CLI (``python -m repro_torch.launch.serve_dfr``); ``serve`` and
``train``, the LM server and trainer (``train`` on one process or on the
ranks of a mesh, ``mesh``); ``dryrun`` and ``calibrate``, the dry run of
every (arch × shape × mesh) cell on a fake process group."""

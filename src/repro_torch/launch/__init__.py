"""Launchers of the port (port of ``repro.launch``): ``serve.py``, the
serving CLI (``python -m repro_torch.launch.serve``); ``train.py``, the
training CLI (``python -m repro_torch.launch.train``); ``mesh.py``, the
production meshes (a fake process group of 256 / 512 ranks) and the
one-device host mesh; ``steps.py``, the train / prefill / serve step of
each (arch x shape) with its shape-only inputs and shardings; and
``dryrun.py``, the dry run over the production meshes (``python -m
repro_torch.launch.dryrun``), to which ``serve --dry-run`` and ``train
--dry-run`` delegate.
"""

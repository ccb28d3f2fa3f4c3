"""Launchers of the port: ``serve.py``, the serving CLI
(``python -m repro_torch.launch.serve``). Port of ``repro.launch``; the
mesh, dry-run and training launchers come with training and sharding.
"""

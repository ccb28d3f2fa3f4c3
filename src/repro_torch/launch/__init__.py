"""Launchers of the port: ``serve.py``, the serving CLI
(``python -m repro_torch.launch.serve``), and ``train.py``, the training
CLI (``python -m repro_torch.launch.train``). Port of ``repro.launch``; the
mesh and dry-run launchers come with sharding.
"""

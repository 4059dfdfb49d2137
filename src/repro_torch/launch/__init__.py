"""Deployment helpers of the PyTorch/CUDA port: operator placement
(``mesh``) and the serving population (``dscep_run``)."""

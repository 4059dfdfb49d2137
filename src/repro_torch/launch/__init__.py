"""Deployment of the PyTorch/CUDA port: device meshes and operator
placement (``mesh``), and the DSCEP launcher (``dscep_run``)."""

"""Deployment of the PyTorch/CUDA port: device meshes and operator
placement (``mesh``), the DSCEP launcher (``dscep_run``) and the LM
serving launcher (``serve``)."""

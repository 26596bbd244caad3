"""Entry points of the port: the LM server (``python -m
repro_torch.launch.serve``) and its step builders."""

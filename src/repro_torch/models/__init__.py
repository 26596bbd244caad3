"""Models of the port: the deepseek-v2-lite MLA + MoE serving path."""

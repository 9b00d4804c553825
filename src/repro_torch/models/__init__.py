"""The LM of the port: the dense, MoE, SSM and hybrid decoder families."""

"""Process meshes over ``torch.distributed``."""

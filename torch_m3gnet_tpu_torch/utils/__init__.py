from torch_m3gnet_tpu_torch.utils.cells import rotate_cell, strain_cell

__all__ = ["rotate_cell", "strain_cell"]

from .mesh import Mesh, barrier, fold_in, get_mesh, init_multihost, is_writer, local_address, pad_to_multiple

__all__ = ["Mesh", "barrier", "fold_in", "get_mesh", "init_multihost", "is_writer", "local_address",
           "pad_to_multiple"]

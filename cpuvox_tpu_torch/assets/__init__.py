from .mesh import SimpleMesh, rescale
from .obj import import_obj
from .voxelizer import voxelize_mesh

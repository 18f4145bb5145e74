from . import conv3x3, mesh

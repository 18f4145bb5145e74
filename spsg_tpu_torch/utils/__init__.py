from . import visualize

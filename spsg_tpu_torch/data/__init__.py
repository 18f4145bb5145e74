from . import formats, colorspace, category, pipeline, synthetic

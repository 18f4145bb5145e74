from . import chunks, fusion, params, scan, semantics, sens

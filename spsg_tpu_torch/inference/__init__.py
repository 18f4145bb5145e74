from . import chunked

from .generator import Generator, GeneratorConfig

"""The benchmark's input generators: training chunks with frames, and rooms."""

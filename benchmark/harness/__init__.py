"""General parts of the benchmark: the manifest and the files it names, the
inputs drawn from the seed, the weights, the frozen peaks and counts, the
trace reader and the import guard. Nothing here is specific to a cell."""

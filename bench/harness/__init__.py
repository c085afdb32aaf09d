"""The benchmark's harness: the manifest and the files it names, weights
and prompts from the seed, the drivers of each traffic kind, the profiled
stretch and the output check."""

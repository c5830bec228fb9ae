"""The LM substrate: params, layers, GQA attention and the dense decoder."""

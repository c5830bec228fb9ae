"""Entry points: ``launch/serve.py`` (prefill + greedy decode)."""

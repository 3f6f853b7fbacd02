"""The benchmark's own tests: python -m pytest benchmark/tests (-m gpu on the card)."""

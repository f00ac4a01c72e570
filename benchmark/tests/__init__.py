"""CPU tests of the benchmark (`python -m pytest benchmark/tests`); the
`cuda` ones need the card."""

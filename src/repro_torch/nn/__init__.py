"""Functional NN layers, attention and the transformer depth stack."""

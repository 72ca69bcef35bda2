"""Receive-chain constructors and command-line apps."""

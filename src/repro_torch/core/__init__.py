"""Core maths of the port: quantizers, codebooks, STEs and MDDQ."""

"""The plain reference of the benchmark: MalGen's chunk streams, the
site x week histogram, MalStone B, the queries and the shuffle's
accounting, worked out again from the seed and the configuration in plain
PyTorch. It imports nothing of the program (``repro_torch``), of the JAX
package (``repro``) or of JAX."""

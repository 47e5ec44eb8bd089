"""The port's counterparts of the JAX package's tools in scripts/: the row
and pair kernel microbenches, the EP cost decomposition, the
preprocessing rehearsal and the BN ceiling. Each keeps its JAX file's
name and runs as `python -m dagnn_tpu_torch.scripts.<name>`, on the card
unless given --cpu (the rehearsal is host work only)."""

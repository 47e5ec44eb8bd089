"""Host-side utilities: DAG plotting (plot.py, a copy of the JAX
package's)."""

from dagnn_tpu_torch.utils.plot import plot_dag  # noqa: F401

"""Host-side utilities: DAG plotting (plot.py, a copy of the JAX
package's) and trace capture and summary (profiling.py, on
torch.profiler)."""

from dagnn_tpu_torch.utils.plot import plot_dag  # noqa: F401

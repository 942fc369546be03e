from .profiling import device_memory_stats, profile_trace, set_debug_nans
from .summary import model_summary, param_count, render_model_graph

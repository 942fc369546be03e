from .continuous import (MultiModalSweeper, TSSweeper, VideoSweeper, alarm_times,
                         bucket_len, chunkify_starts, moving_average,
                         multimodal_ladders, predict_0d_shot,
                         predict_multimodal_shot, predict_video_shot,
                         startup_suppression, warning_time)
from .latency import measure_forward, measure_model
from .streaming import (StreamingPredictor, choose_block_size,
                        probe_stream_blocks)

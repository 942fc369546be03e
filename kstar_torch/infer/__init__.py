from .continuous import (VideoSweeper, alarm_times, bucket_len, chunkify_starts,
                         moving_average, predict_video_shot,
                         startup_suppression, warning_time)

"""The port's figures and explanations (``kstar_tpu/viz``): probability
curves and the real-time GIF, latent-space views, Grad-CAM, guided backprop
and attention rollout. matplotlib and sklearn are imported inside the
functions that draw or project."""

from .latent import (collect_latents, project, visualize_latent_space,
                     visualize_latent_space_multi)
from .prob_curve import (plot_learning_curve, plot_shot_probability,
                         plot_shot_probability_zoom, render_realtime_gif,
                         show_all_frames)
from .xai import (collect_attention, gradcam_r2plus1d, guided_backprop,
                  guided_backprop_saliency, overlay_cam, rollout,
                  vivit_attention_rollout)

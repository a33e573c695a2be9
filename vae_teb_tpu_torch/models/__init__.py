"""Model families: blocks, the SeqVaeTeb sequence VAE, the forecast and
predict-st variants, and the InceptionTime classifier."""

from .blocks import (LSTM, CausalConv1d, CausalConvBlock, LSTMStream,
                     ReflectConvBlock, ResidualMLP, geometric_schedule,
                     linear_upsample, run_lstm_streams)
from .inception_time import (InceptionBlock, InceptionTimeClassifier,
                             ResidualBlock, SelfAttention, SeqVaeTebClassifier,
                             cross_entropy_loss)
from .vae_teb import (ConditionalEncoder, Decoder, SeqVaeTeb, SourceEncoder,
                      TargetEncoder, compute_loss, decoder_loss, gaussian_kld,
                      gaussian_nll, source_stream_init_state,
                      stitch_predictions)
from .variants import (ConvWindowDecoder, DirectWindowDecoder,
                       PredictStDecoder, SeqVaeTebForecast,
                       SeqVaeTebPredictSt, future_window_targets, ldam_loss,
                       predict_st_loss, sliding_window_nll)

__all__ = [
    "LSTM", "CausalConv1d", "CausalConvBlock", "LSTMStream",
    "ReflectConvBlock", "ResidualMLP", "geometric_schedule",
    "linear_upsample", "run_lstm_streams",
    "ConditionalEncoder", "Decoder", "SeqVaeTeb", "SourceEncoder",
    "TargetEncoder", "compute_loss", "decoder_loss", "gaussian_kld",
    "gaussian_nll", "source_stream_init_state", "stitch_predictions",
    "ConvWindowDecoder", "DirectWindowDecoder", "PredictStDecoder",
    "SeqVaeTebForecast", "SeqVaeTebPredictSt", "future_window_targets",
    "ldam_loss", "predict_st_loss", "sliding_window_nll",
    "InceptionBlock", "InceptionTimeClassifier", "ResidualBlock",
    "SelfAttention", "SeqVaeTebClassifier", "cross_entropy_loss",
]

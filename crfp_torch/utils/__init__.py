from crfp_torch.utils.logging import Logger, MetricsWriter, mk_exp_dir

__all__ = ["Logger", "mk_exp_dir", "MetricsWriter"]

from alpha_zero_tpu_torch.eval.elo import EloRating, get_k_factor  # noqa: F401

from gpsat_tpu_torch.optim.lbfgs import minimize_lbfgs

__all__ = ["minimize_lbfgs"]

from .residuals import error_residuals, internal_norm, scaled_error_norm

__all__ = ["error_residuals", "internal_norm", "scaled_error_norm"]

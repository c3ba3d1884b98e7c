from .linear import LinearForwardProblem

__all__ = ["LinearForwardProblem"]

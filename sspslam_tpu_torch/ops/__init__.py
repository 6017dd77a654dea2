from . import vsa

__all__ = ["vsa"]

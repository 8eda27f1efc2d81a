from .io import save_eigpairs

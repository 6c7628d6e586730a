"""Host-side native code of the port: the g++ lattice codec (codec.py)."""

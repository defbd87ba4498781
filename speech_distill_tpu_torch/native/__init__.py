"""Host-side native code of the port (C++ over ctypes, built at first
use by g++)."""

"""Native C++ codec: build (``build.py``) and ctypes bindings (``runtime.py``)."""

__version__ = "0.1.0"
# Capability target: PengNi/ccsmeth v0.5.0 (reference ccsmeth/_version.py)
CCSMETH_COMPAT_VERSION = "0.5.0"

from .casmo import CasmopolitanTrManager, ProxyTrManager

__all__ = ["CasmopolitanTrManager", "ProxyTrManager"]

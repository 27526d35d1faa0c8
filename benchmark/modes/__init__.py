"""The modes that drive a traffic mix, one module a traffic ``kind``."""

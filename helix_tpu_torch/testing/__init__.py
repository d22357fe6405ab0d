"""Test-support switchboards of the port (fault injection)."""

"""Block-parallel execution of stream-op chains on one device."""

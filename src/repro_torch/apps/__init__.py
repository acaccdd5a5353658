"""The paper's benchmark apps on the port's tile runtime."""

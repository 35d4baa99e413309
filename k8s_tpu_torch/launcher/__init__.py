"""In-pod launcher of the port (the operator's env contract)."""

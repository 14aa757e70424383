"""Config loading, logging and device selection for the port."""

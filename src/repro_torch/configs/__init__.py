"""Architecture configs (copies of the reference's): ``get_config(name)``."""

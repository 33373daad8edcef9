from .synthetic import PlantedCoClusters, planted_cocluster_matrix, to_bcoo

__all__ = ["PlantedCoClusters", "planted_cocluster_matrix", "to_bcoo"]

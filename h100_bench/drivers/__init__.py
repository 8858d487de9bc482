"""Traffic drivers: ``drivers/<driver>.py`` defines ``Driver``, named by a traffic mix."""

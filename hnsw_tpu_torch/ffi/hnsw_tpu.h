/* C ABI of the hnsw_tpu native core (libhnsw_core.so).
 *
 * Capability analog of the reference's FFI surface (libext.rs): opaque handles,
 * insert/search/parallel variants, custom distances, plus flat-array exports for
 * zero-copy handoff to the JAX/TPU search path. Vectors are float32; integer
 * element types are converted by the caller (the Python tier keeps native dtypes).
 */
#ifndef HNSW_TPU_H
#define HNSW_TPU_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef float (*hnsw_dist_fn)(const float*, const float*, uint64_t);
typedef int (*hnsw_filter_fn)(int64_t data_id);

/* distname: one of "L1","L2","Cosine","Dot","Hamming","Jaccard","Hellinger",
 * "Jeffreys","JensenShannon" (an optional "Dist" prefix is accepted).
 * Returns NULL if max_nb_conn == 0 or > 256. */
void* hnsw_init(uint64_t max_nb_conn, uint64_t ef_construction,
                uint64_t max_elements, uint64_t max_layer, const char* distname);
void* hnsw_init_ptrdist(uint64_t max_nb_conn, uint64_t ef_construction,
                        uint64_t max_elements, uint64_t max_layer, hnsw_dist_fn fn);
void hnsw_drop(void* h);

void hnsw_set_extend_candidates(void* h, int flag);
void hnsw_set_keeping_pruned(void* h, int flag);
void hnsw_modify_level_scale(void* h, double factor); /* clamped to [0.2, 1.0] */

void hnsw_insert(void* h, const float* v, uint64_t dim, int64_t data_id);
void hnsw_parallel_insert(void* h, const float* vs, uint64_t n, uint64_t dim,
                          const int64_t* ids, int n_threads /* 0 = hw default */);

/* out_ids/out_d must hold knbn entries; returns the count found. */
uint64_t hnsw_search(void* h, const float* q, uint64_t knbn, uint64_t ef,
                     int64_t* out_ids, float* out_d);
uint64_t hnsw_search_filter(void* h, const float* q, uint64_t knbn, uint64_t ef,
                            hnsw_filter_fn filter, int64_t* out_ids, float* out_d);
void hnsw_parallel_search(void* h, const float* qs, uint64_t nq, uint64_t knbn,
                          uint64_t ef, int n_threads, int64_t* out_ids,
                          float* out_d); /* row-major [nq, knbn], -1/inf padded */

/* persistence: reference-format v4 dump/reload (interchangeable with the Python
 * tier's reader/writer). hnsw_load returns a handle of the dumped element type
 * (query it with hnsw_element_type: 0=f32 1=f64 2=i32 3=u32 4=u16 5=u8). */
int32_t hnsw_file_dump(void* h, const char* dir, const char* basename);
void* hnsw_load(const char* dir, const char* basename);
int32_t hnsw_element_type(void* h);

/* Dump-header introspection without loading the index (analog of the reference's
 * load_hnsw_description + DescriptionFFI, libext.rs:1121-1232). Returns 0 on
 * success, negative on open/parse failure. Accepts format v3 and v4. */
typedef struct {
  int32_t format_version; /* 3 or 4 */
  int32_t dumpmode;       /* 1 = Full, 0 = Light */
  int32_t max_nb_connection;
  int32_t nb_layer;
  double level_scale;
  uint64_t ef_construction;
  uint64_t nb_point;
  uint64_t dimension;
  char distname[64]; /* NUL-terminated, truncated if longer */
  char t_name[16];   /* "f32","f64","i32","u32","u16","u8" */
} hnsw_description;
int32_t hnsw_load_description(const char* dir, const char* basename,
                              hnsw_description* out);

/* Graph-only (NoData) reload: topology + metadata without reading the data file
 * (analog of the reference's NoData reload, libext.rs:446-451). Searching a
 * graph-only handle returns 0 results; exports/meta/dump work. */
void* hnsw_load_graph_only(const char* dir, const char* basename);

/* Typed variants exist for every data-path function: hnsw_init_{f32,f64,i32,u32,
 * u16,u8}, hnsw_insert_<t>, hnsw_parallel_insert_<t>, hnsw_search_<t>,
 * hnsw_search_filter_<t>, hnsw_parallel_search_<t>, hnsw_export_data_<t>.
 * The unsuffixed names below are the f32 instance. */

/* introspection + flat-array export (dense rows, -1/inf padded) */
uint64_t hnsw_nb_points(void* h);
uint64_t hnsw_dim(void* h);
int64_t hnsw_entry_point(void* h);
int32_t hnsw_max_level_used(void* h);
int64_t hnsw_layer_count(void* h, int32_t layer);
double hnsw_level_scale(void* h);
void hnsw_export_meta(void* h, int64_t* origin, int32_t* level, int32_t* rank);
void hnsw_export_data(void* h, float* out /* [n, dim] */);
void hnsw_export_layer(void* h, int32_t layer, int32_t* ids /* [n, width] */,
                       float* dists /* [n, width] */);

#ifdef __cplusplus
}
#endif
#endif /* HNSW_TPU_H */
